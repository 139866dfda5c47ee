"""Seeded (read, haplotype) rows for the vapor_tpu_torch engine tests.

JAX-free, so the card-only tests (tests/test_torch_cuda.py) can use it on
a machine without jax."""
import numpy as np

from vapor_tpu_torch.engine.constants import HAP_PAD, READ_PAD


def random_rows(H, R, B, seed, ms=(0,), err=0.08):
    """(haps, reads, rlens, ms) numpy rows: each read is copied from its
    hap with substitutions at rate err and, on every other row, a
    reverse-complement stretch (so the reverse strand hits); row b gets
    m = ms[b % len(ms)]."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    comp = np.zeros(256, np.uint8)
    comp[bases] = np.frombuffer(b"TGCA", np.uint8)
    haps = np.full((B, H), HAP_PAD, np.uint8)
    reads = np.full((B, R), READ_PAD, np.uint8)
    rlens = np.zeros(B, np.int32)
    for b in range(B):
        hap_len = H - int(rng.integers(5, 60))
        hap = bases[rng.integers(0, 4, hap_len)]
        haps[b, :hap_len] = hap
        rlen = min(R - int(rng.integers(1, 60)), hap_len)
        src = hap[:rlen].copy()
        if b % 2 == 0 and rlen > 320:
            src[200:300] = comp[src[50:150][::-1]]
        flips = rng.integers(0, rlen, int(rlen * err))
        src[flips] = bases[rng.integers(0, 4, flips.size)]
        reads[b, :rlen] = src
        rlens[b] = rlen
    m = np.array([ms[b % len(ms)] for b in range(B)], np.int32)
    return haps, reads, rlens, m
