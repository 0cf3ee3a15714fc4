"""Bit-exact port of ``jax.random`` as the FleetSim engine uses it.

The reference draws every random number from JAX's threefry2x32 generator
on the ``jax_threefry_partitionable=False`` stream (the stream the goldens in
``tests/golden/`` were captured in).  This module reproduces that stream
word for word: ``PRNGKey``, ``split``, ``fold_in``, ``uniform`` (float32)
and ``poisson`` (Knuth's method below λ = 10, Hörmann's transformed
rejection above it).

Conventions:

* a key is an int64 tensor whose last axis holds the two uint32 words;
  keys are batched — ``(G, 2)``, one key per configuration, or any
  ``(..., 2)`` — and every draw keeps the keys' leading axes;
* uint32 arithmetic runs in int64 with an explicit ``& 0xFFFFFFFF`` mask,
  because torch's uint32 support is partial;
* the float library functions the samplers call (``log``, ``lgamma``) are
  evaluated in float64 and rounded to float32, so the CPU and the GPU give
  the same bits.  XLA's float32 versions are not correctly rounded, so a
  draw can differ from the reference by one ulp there; see ``ROADMAP.md``
  queue C for where that shows.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block function on broadcastable int64 tensors
    holding uint32 values; returns the two output words.

    Only ``x1`` is masked to 32 bits each round (the rotation needs it
    exact); ``x0`` is left to carry bits above bit 31, which never reach
    the low 32 bits of a sum or a xor, and is masked once at the end
    (it stays below 2^38, far inside int64)."""
    k2 = k0 ^ k1 ^ _KS_PARITY
    ks = (k0, k1, k2)
    x0 = x0 + k0
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & MASK32
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + (ks[(i + 2) % 3] + (i + 1))) & MASK32
    return x0 & MASK32, x1


def _hash(key: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """``threefry_2x32(key, counts)`` for every key of a batch: ``key``
    ``(..., 2)``, ``counts`` 1-D; returns ``(..., len(counts))``.  The
    counts are cut in two halves (padded with one zero when odd) that form
    the two input words, as the reference does."""
    n = counts.shape[0]
    if n % 2:
        counts = torch.cat([counts, counts.new_zeros(1)])
    half = counts.shape[0] // 2
    y0, y1 = threefry2x32(key[..., 0:1], key[..., 1:2], counts[:half],
                          counts[half:])
    return torch.cat([y0, y1], dim=-1)[..., :n]


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def PRNGKey(seed: torch.Tensor) -> torch.Tensor:
    """Keys from integer seeds ``(G,)``: ``[0, seed mod 2^32]``, as
    ``jax.random.PRNGKey`` builds them from a 32-bit seed."""
    seed = torch.as_tensor(seed).to(torch.int64)
    return torch.stack([torch.zeros_like(seed), seed & MASK32], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` for every key of a batch:
    ``(..., 2) -> (..., num, 2)``."""
    bits = _hash(key, _iota(2 * num, key.device))
    return bits.reshape(*key.shape[:-1], num, 2)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` for every key of a batch, with one Python
    int.  The counter words ``[0, data]`` are made on the key's device (no
    host-to-device copy, so a CUDA graph can capture the call)."""
    counts = _iota(2, key.device) * (int(data) & MASK32)
    return _hash(key, counts)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """Map 32-bit words to float32 in ``[0, 1)`` exactly as ``jax.random.
    uniform`` does: the top 23 bits become the mantissa of a float in
    ``[1, 2)``, from which 1 is subtracted."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32 for every key of a
    batch: ``(..., 2) -> (..., *shape)``."""
    bits = _hash(key, _iota(math.prod(shape), key.device))
    return bits_to_uniform(bits).reshape(*key.shape[:-1], *shape)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log``, correctly rounded on every device (see module doc)."""
    return torch.log(x.to(torch.float64)).to(torch.float32)


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log1p``, correctly rounded on every device."""
    return torch.log1p(x.to(torch.float64)).to(torch.float32)


def lgamma_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``lgamma``, correctly rounded on every device."""
    return torch.lgamma(x.to(torch.float64)).to(torch.float32)


def pow_f32(x: torch.Tensor, y: float) -> torch.Tensor:
    """float32 ``x ** y``, correctly rounded on every device."""
    return torch.pow(x.to(torch.float64), float(y)).to(torch.float32)


def over(number: float, t: torch.Tensor) -> torch.Tensor:
    """``number / t`` as one float32 division, as XLA divides: torch's
    ``number / t`` is ``reciprocal(t) * number``, two roundings, on every
    device (ROADMAP C9; ``tools/check_rdivision.py`` counts what it
    moved).  A fill, not a host-to-device copy, so graph capture holds."""
    return torch.full_like(t, number) / t


def _poisson_knuth(key, lam, n):
    """Knuth's method, one while loop per configuration.  A configuration
    whose loop has ended keeps drawing in the batched loop, which changes
    nothing: its counts stop once every running log-product is below
    ``-lam``."""
    g = lam.shape[0]
    k = torch.zeros((g, n), dtype=torch.int32, device=lam.device)
    log_prod = torch.zeros((g, n), dtype=torch.float32, device=lam.device)
    neg_lam = -lam[:, None]
    while bool((log_prod > neg_lam).any()):
        keys = split(key, 2)
        key, sub = keys[:, 0], keys[:, 1]
        k = torch.where(log_prod > neg_lam, k + 1, k)
        log_prod = log_prod + log_f32(uniform(sub, (n,)))
    return k - 1


def _poisson_rejection(key, lam, n, running):
    """Hörmann's transformed rejection.  Every element keeps the value of
    its *last* accepting iteration, so a configuration's carry is frozen as
    soon as all its elements have been accepted (the batched loop of the
    reference does the same per ``vmap`` lane).  ``running`` masks the
    configurations that take this branch at all."""
    lam = lam[:, None]
    log_lam = log_f32(lam)
    b = 0.931 + 2.53 * torch.sqrt(lam)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2)
    g = lam.shape[0]
    k_out = torch.full((g, n), -1.0, dtype=torch.float32, device=lam.device)
    accepted = ~running[:, None].expand(g, n).clone()
    while True:
        live = (~accepted).any(dim=1)
        if not bool(live.any()):
            break
        keys = split(key, 3)
        key, sub0, sub1 = keys[:, 0], keys[:, 1], keys[:, 2]
        u = uniform(sub0, (n,)) - 0.5
        v = uniform(sub1, (n,))
        u_shifted = 0.5 - torch.abs(u)
        k = torch.floor((2 * a / u_shifted + b) * u + lam + 0.43)
        s = log_f32(v * inv_alpha / (a / (u_shifted * u_shifted) + b))
        t = -lam + k * log_lam - lgamma_f32(k + 1)
        accept1 = (u_shifted >= 0.07) & (v <= v_r)
        reject = (k < 0) | ((u_shifted < 0.013) & (v > u_shifted))
        accept2 = s <= t
        accept = (accept1 | (~reject & accept2)) & live[:, None]
        k_out = torch.where(accept, k, k_out)
        accepted = accepted | accept
    return k_out.to(torch.int32)


def poisson(key: torch.Tensor, lam: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.poisson(key, lam, (n,))`` per configuration: ``key``
    ``(G, 2)``, ``lam`` ``(G,)`` float32 -> ``(G, n)`` int32.  Both branches
    of the reference are ported; each configuration takes the one its rate
    selects."""
    lam = lam.to(torch.float32)
    use_knuth = torch.isnan(lam) | (lam < 10)
    knuth = _poisson_knuth(key, torch.where(use_knuth, lam,
                                            torch.zeros_like(lam)), n)
    rejection = _poisson_rejection(
        key, torch.where(use_knuth, torch.full_like(lam, 1e5), lam), n,
        running=~use_knuth)
    out = torch.where(use_knuth[:, None], knuth, rejection)
    return torch.where((lam == 0)[:, None], torch.zeros_like(out), out)
