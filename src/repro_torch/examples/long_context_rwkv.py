"""Long-context decode with an attention-free architecture.

Why the rwkv6/jamba families run the long_500k cell: the decode state is
O(1) in context length (a per-layer matrix state), so a token deep in a
524,288-token context costs what a token at position 0 does.  A reduced
RWKV-6 decodes at positions far into a simulated 500k context while its
state stays a few MB.

Run:  python -m repro_torch.examples.long_context_rwkv [--device cpu]
(with PYTHONPATH=src from the repository root)
"""

import time

import torch

from repro_torch import configs
from repro_torch.examples.common import parse_device
from repro_torch.models import transformer as T

B = 2
# positions deep into a simulated 500k context
POSITIONS = (0, 1, 131072, 524287)


def main(argv=None) -> None:
    dev = parse_device(__doc__, argv).device
    cfg = configs.get_config("rwkv6-7b").reduced()
    model = T.init_params(cfg, 0, dev)
    cache = T.init_cache(cfg, B, 8, dev)    # no position axis: O(1) state

    state_bytes = sum(t.numel() * t.element_size()
                      for st in cache for t in st.values())
    kv_gib = cfg.n_layers * 2 * B * 524288 * cfg.d_model * 2 / 2 ** 30
    print(f"decode state: {state_bytes / 2 ** 20:.2f} MiB (vs a 500k-token "
          f"KV cache: {kv_gib:.1f} GiB for an attention model of this "
          f"width)")

    tok = torch.ones((B,), dtype=torch.long, device=dev)
    for pos in POSITIONS:
        t0 = time.perf_counter()
        logits, cache = T.forward_decode(model, cache, {"token": tok}, pos)
        finite = bool(torch.isfinite(logits).all())   # waits for the step
        dt = time.perf_counter() - t0
        if not finite:
            raise AssertionError(f"non-finite logits at position {pos}")
        print(f"  token at position {pos:6d}: {dt * 1e3:6.1f} ms, logits "
              f"finite on {dev.type}")
    print("state leaves:", [tuple(t.shape) for t in cache[0].values()])


if __name__ == "__main__":
    main()
