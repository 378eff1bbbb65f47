"""The generator of the division mixes: operands and the order calls
send them in, drawn from `--seed` and the parameters of a configuration
and a mix (plain JSON data).

Every seed gets the same set of sizes in another order: operand lengths
are stratified over their range within every batch and permuted by the
seed.  So a seed changes which operands meet, not how much work there
is.  Limbs are base 2^16, int32, little-endian; an operand of p limbs
has a nonzero limb p - 1 and zeros above it.  The limbs are drawn on
the device the program runs on, by a `torch.Generator` seeded from the
seed, in one call per batch and operand.
"""

from __future__ import annotations

import numpy as np

BASE = 1 << 16


def rng(seed: int, *salt: int) -> np.random.Generator:
    """A generator for (seed, *salt): any whole seed, negative or past
    64 bits included."""
    return np.random.Generator(np.random.PCG64(_seq(seed, *salt)))


def _seq(seed: int, *salt: int) -> np.random.SeedSequence:
    words = [int(seed) & (2 ** 64 - 1), int(seed) >> 64 & (2 ** 64 - 1)
             if seed >= 0 else 1, *salt]
    return np.random.SeedSequence(words)


def torch_generator(torch, device, seed: int, *salt: int):
    """A torch.Generator on `device` seeded from (seed, *salt)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(_seq(seed, *salt).generate_state(1, np.uint64)[0]
                      >> np.uint64(1)))
    return g


def stratified_lengths(lo: int, hi: int, batches: int, batch: int,
                       g: np.random.Generator) -> np.ndarray:
    """(batches, batch) lengths in [lo, hi]: lane j of each batch draws
    from the j-th of `batch` equal slices of the range, the lanes in the
    seed's order.  Every batch then holds the same spread of lengths, so
    no seed gathers the longest work into a few batches (a call lasts
    as long as its longest lane)."""
    edges = lo + (np.arange(batch + 1) * (hi - lo + 1)) // batch
    lo_j = np.minimum(edges[:-1], hi)
    hi_j = np.maximum(edges[1:], lo_j + 1)
    out = g.integers(lo_j, hi_j, size=(batches, batch))
    return np.array([g.permutation(row) for row in out])


def limbs_of_length(torch, lengths: np.ndarray, m: int, gen, device):
    """(n, m) int32 limbs on `device`, row i uniform over the ints of
    exactly lengths[i] limbs (0 for a length of 0)."""
    n = len(lengths)
    out = torch.randint(0, BASE, (n, m), generator=gen, device=device,
                        dtype=torch.int32)
    ln = torch.as_tensor(lengths, dtype=torch.int64, device=device)
    out.masked_fill_(torch.arange(m, device=device)[None, :] >= ln[:, None],
                     0)
    top = torch.randint(1, BASE, (n,), generator=gen, device=device,
                        dtype=torch.int32)
    rows = torch.nonzero(ln > 0).flatten()
    out[rows, ln[rows] - 1] = top[rows]
    return out


def division_pool(torch, config: dict, batches: int, batch: int, seed: int,
                  device):
    """(u, v, lu, lv): u and v (batches, batch, m) int32 on `device`, u
    of a length drawn from config["operands"]["u_limbs"], v from
    ["v_limbs"] (inclusive ranges, stratified within every batch); lu
    and lv the lengths, (batches, batch) on the host."""
    m = config["m_limbs"]
    law = config["operands"]
    g = rng(seed, 1)
    lu = stratified_lengths(*law["u_limbs"], batches, batch, g)
    lv = stratified_lengths(*law["v_limbs"], batches, batch, g)
    gen = torch_generator(torch, device, seed, 8)
    u = torch.empty(batches, batch, m, dtype=torch.int32, device=device)
    v = torch.empty_like(u)
    for b in range(batches):
        u[b] = limbs_of_length(torch, lu[b], m, gen, device)
        v[b] = limbs_of_length(torch, lv[b], m, gen, device)
    return u, v, lu, lv


def call_order(n_batches: int, seed: int) -> np.ndarray:
    """The order the pool's batches are sent in, cycled."""
    return rng(seed, 2).permutation(n_batches)
