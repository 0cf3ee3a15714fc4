"""The seven registered policies with LÆDGE's coordinator and the hedge
timer on, at 1 and 2 racks, under each filter backend: every ``Metrics``
field of a 1,500-tick run bit-identical to the reference's, on the CPU
(the counterpart of ``tests/test_fleetsim_stages.py::
test_enabled_stages_leave_stock_policies_bit_identical``, which the goldens
pin for the always-on five).  The fabric, the params and the reference's
modules are ``test_torch_stages.py``'s; the reference runs under
``jax.threefry_partitionable(False)`` (ROADMAP C0).
"""

import functools

import pytest

import repro_torch.fleetsim as tf
from test_torch_stages import (POLICIES, _assert_metrics_equal, _cfg, _cfgs,
                               _params, _ref)
from test_torch_common import _one_torch_thread  # noqa: F401


@functools.lru_cache(maxsize=None)
def _reference_run(n_racks: int):
    jax, _, rf = _ref()[:3]
    rcfg, _ = _cfgs(n_racks=n_racks, n_ticks=1500)
    with jax.threefry_partitionable(False):
        return jax.device_get(rf.simulate(rcfg, _params(rf, rcfg, POLICIES)))


@pytest.mark.parametrize("backend",
                         ["vectorized", "scan", "pallas", "tickfuse"])
@pytest.mark.parametrize("n_racks", [1, 2])
def test_stages_on_every_policy_bit_identical(n_racks, backend):
    """The seven policies as one batch with the coordinator and hedge
    timer on, 1,500 ticks: every ``Metrics`` field equals the reference's
    (its ``vectorized`` run; the reference's filter backends agree bit for
    bit).  LÆDGE's lanes pair at the top tier (filter group ``n_racks``),
    so B1 and B2's plain versions filter there."""
    tcfg = _cfg(tf, n_racks=n_racks, n_ticks=1500, filter_backend=backend)
    got = tf.simulate(tcfg, _params(tf, tcfg, POLICIES), device="cpu")
    want = _reference_run(n_racks)
    _assert_metrics_equal(got, want, f"{n_racks} racks, {backend}")
    lae, hdg = POLICIES.index("laedge"), POLICIES.index("hedge")
    assert int(got.n_coord_queued[lae]) > 0 and int(got.n_cloned[lae]) > 0
    assert int(got.n_filtered[lae]) > 0
    assert int(got.n_hedges_armed[hdg]) > 0 and int(got.n_cloned[hdg]) > 0
