#!/usr/bin/env python3
"""Count where a Python number divided by a tensor moves the port's draws
away from the reference's (ROADMAP C9), on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/check_rdivision.py [--n 4194304]

``number / tensor`` in torch is ``reciprocal(tensor) * number`` on every
device (``Tensor.__rtruediv__``): two roundings, where the reference's XLA
divides once.  Two places of the port's sampling had that form:

* the bounded-Pareto service draw, ``xm / pow(1 - u (1 - r), 1/alpha)``
  (``repro_torch.fleetsim.stages._intrinsic``);
* the constants of the Poisson rejection branch, ``1.1328 / (b - 3.4)``
  and ``3.6224 / (b - 2)`` (``repro_torch.random._poisson_rejection``).

For each, this prints how many of ``--n`` draws (the Pareto over uniforms
from seed 0 at the default ``ServiceSpec.pareto()``; the Poisson over 64
rates log-spaced in [10, 2000], ``n / 64`` draws each, keys from seeds
0-63) differ from the reference's under the reciprocal form and under
tensor division (``repro_torch.random.over``).  The port runs the form
that moves fewer draws: tensor division for the Pareto, the reciprocal
form for the Poisson constants, where both move the same draws (the rest
differ through the float32 lgamma and log, ROADMAP C9) and the division
would cost two fills a tick.  Imports the reference
(``repro``) and JAX: a development tool, not part of the port.
"""

from __future__ import annotations

import argparse

import numpy as np


def pareto_counts(n: int) -> dict:
    import jax.numpy as jnp
    import torch

    import repro.fleetsim as rf
    import repro_torch.fleetsim as tf
    from repro.fleetsim import stages as rst
    from repro_torch import random as jr
    from repro_torch.fleetsim import stages as tst

    u = np.random.default_rng(0).random(n, dtype=np.float32)
    svc = tf.ServiceSpec.pareto()
    want = np.asarray(rst._intrinsic(
        rf.FleetConfig(service=rf.ServiceSpec.pareto()), jnp.asarray(u)))
    port = tst._intrinsic(tf.FleetConfig(service=svc),
                          torch.from_numpy(u)).numpy()
    xm, alpha, cap = svc.params
    uc = torch.clamp(torch.from_numpy(u), max=tst._f32(1.0 - 1e-7))
    p = jr.pow_f32(1.0 - uc * (1.0 - (xm / cap) ** alpha),
                   tst._f32(1.0 / alpha))
    forms = {"reciprocal": (xm / p).numpy(),
             "tensor division": jr.over(xm, p).numpy()}
    out = {k: int((v != want).sum()) for k, v in forms.items()}
    out["port"] = int((port != want).sum())
    return out


def poisson_counts(n: int) -> dict:
    import jax
    import jax.numpy as jnp
    import torch

    from repro_torch import random as jr

    lams = np.geomspace(10.0, 2000.0, 64).astype(np.float32)
    per = n // len(lams)
    seeds = np.arange(len(lams), dtype=np.int32)
    with jax.threefry_partitionable(False):
        keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))
        want = np.asarray(jax.jit(jax.vmap(
            lambda k, lam: jax.random.poisson(k, lam, (per,))))(
                keys, jnp.asarray(lams)))
    def draws():
        return jr.poisson(jr.PRNGKey(torch.from_numpy(seeds)),
                          torch.from_numpy(lams), per).numpy()

    out = {"draws": per * len(lams), "reciprocal (the port)": int(
        (draws() != want).sum())}
    # every number-over-tensor division of the port as a tensor division
    real = torch.Tensor.__rtruediv__
    torch.Tensor.__rtruediv__ = lambda t, number: jr.over(number, t)
    try:
        out["tensor division"] = int((draws() != want).sum())
    finally:
        torch.Tensor.__rtruediv__ = real
    b = torch.from_numpy(0.931 + 2.53 * np.sqrt(lams))
    for name, num, off in (("inv_alpha", 1.1328, 3.4), ("v_r", 3.6224, 2.0)):
        true = np.float32(num) / (b.numpy() - np.float32(off))
        out[f"rates whose {name} differs (reciprocal form)"] = int(
            ((num / (b - off)).numpy() != true).sum())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 22)
    args = ap.parse_args(argv)
    print(f"pareto, {args.n} draws, differing from the reference's: "
          f"{pareto_counts(args.n)}")
    print(f"poisson (rejection branch): {poisson_counts(args.n)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
