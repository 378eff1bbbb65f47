"""The paper's cost model: launches per batched division."""
