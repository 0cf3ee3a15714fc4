"""Run the reference's nightly cross-validation CLI (``python -m
repro.fleetsim.validate``) on the CPU in the PRNG stream the goldens were
made in (``jax_threefry_partitionable`` off, ROADMAP C0), for comparison
with the port's rows (``chip_smoke.py`` phase 12c prints them side by side).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_validate.py \\
        --trace none --out tools/validate_grid_reference.json

Arguments pass through to ``repro.fleetsim.validate.main``.
"""

import sys

import jax

if __name__ == "__main__":
    jax.config.update("jax_threefry_partitionable", False)
    from repro.fleetsim.validate import main

    sys.exit(main(sys.argv[1:]))
