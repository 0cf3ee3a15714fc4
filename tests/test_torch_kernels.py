"""The switch response-path kernels: plain versions ≡ the reference's
Pallas kernels, and the CUDA kernels ≡ their plain versions.

The reference kernels run in interpret mode on the CPU, as
``tests/test_kernels.py`` runs them, one config at a time; the port's plain
versions run the whole ``G`` batch at once.  The CUDA cases need a card
(marker ``cuda``) and skip without one; the reference is imported only by
the tests that use it, so on a machine with a card and no ``jax``

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py

runs the kernel cases alone.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fingerprint_filter import fingerprint_filter
from repro_torch.kernels.inputs import filter_lanes
from repro_torch.kernels.tickfuse import tickfuse_response_path

G, K = 5, 32


def _lanes(seed, n_tables=4, n_slots=64, n_servers=6):
    return filter_lanes(G, K, n_tables, n_slots, n_servers, seed=seed)


def _t(a, device="cpu"):
    return torch.from_numpy(a.copy()).to(device)


def _reference():
    """The reference's Pallas kernels (interpret mode) and numpy oracle."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core.switch_jax import filter_tick_oracle
    from repro.kernels.fingerprint_filter import fingerprint_filter
    from repro.kernels.tickfuse import tickfuse_response_path
    return jnp, fingerprint_filter, tickfuse_response_path, filter_tick_oracle


@pytest.mark.parametrize("seed", range(3))
def test_fingerprint_filter_plain_matches_pallas(seed):
    jnp, ref_ff, _, _ = _reference()
    x = _lanes(seed)
    tables, drop = ref.fingerprint_filter_ref(
        _t(x["tables"]), _t(x["rid"]), _t(x["idx"]), _t(x["clo"]))
    assert drop.any() and not drop.all()     # hits and misses both occur
    for g in range(G):
        want_t, want_d = ref_ff(jnp.asarray(x["tables"][g]),
                                jnp.asarray(x["rid"][g]),
                                jnp.asarray(x["idx"][g]),
                                jnp.asarray(x["clo"][g]), block=32)
        assert np.array_equal(tables[g].numpy(), np.asarray(want_t))
        assert np.array_equal(drop[g].numpy(), np.asarray(want_d))


@pytest.mark.parametrize("seed", range(3))
def test_tickfuse_plain_matches_pallas_and_oracle(seed):
    jnp, _, ref_tf, filter_tick_oracle = _reference()
    x = _lanes(10 + seed)
    sstate, tables, drop = ref.tickfuse_ref(
        _t(x["server_state"]), _t(x["tables"]), _t(x["rid"]), _t(x["idx"]),
        _t(x["clo"]), _t(x["sid"]), _t(x["qlen"]))
    for g in range(G):
        want_s, want_t, want_d = ref_tf(
            *(jnp.asarray(x[n][g]) for n in ("server_state", "tables", "rid",
                                              "idx", "clo", "sid", "qlen")),
            block=32)
        assert np.array_equal(sstate[g].numpy(), np.asarray(want_s))
        assert np.array_equal(tables[g].numpy(), np.asarray(want_t))
        assert np.array_equal(drop[g].numpy(), np.asarray(want_d))
        # the numpy oracle, with the inactive (out-of-range sid) lanes
        # taken out of its StateT loop
        act = x["sid"][g] < x["server_state"].shape[1]
        o_t, o_s, o_d = filter_tick_oracle(
            x["tables"][g], x["server_state"][g],
            *(x[n][g][act] for n in ("rid", "idx", "clo", "sid", "qlen")))
        assert np.array_equal(tables[g].numpy(), o_t)
        assert np.array_equal(sstate[g].numpy(), o_s)
        assert np.array_equal(drop[g].numpy()[act], o_d)


@pytest.mark.parametrize("kernel", ["fingerprint_filter", "tickfuse"])
def test_plain_versions_match_pallas_at_fabric_shape(kernel):
    """The 4-rack fabric's shape: (4 + 1) · 2 = 10 tables, the spine's
    filter group at 8-9, and 24 servers."""
    jnp, ref_ff, ref_tf, _ = _reference()
    x = _lanes(20, n_tables=10, n_servers=24)
    if kernel == "fingerprint_filter":
        names, plain, want_fn = ("tables", "rid", "idx", "clo"), \
            ref.fingerprint_filter_ref, ref_ff
    else:
        names, plain, want_fn = ("server_state", "tables", "rid", "idx",
                                 "clo", "sid", "qlen"), ref.tickfuse_ref, \
            ref_tf
    assert (x["idx"] >= 8).any()
    got = plain(*(_t(x[n]) for n in names))
    for g in range(G):
        want = want_fn(*(jnp.asarray(x[n][g]) for n in names), block=32)
        for a, b in zip(got, want):
            assert np.array_equal(a[g].numpy(), np.asarray(b))


def test_wrappers_take_the_plain_version_on_cpu():
    x = _lanes(3)
    fingerprint_filter.launches = 0
    tickfuse_response_path.launches = 0
    t1, d1 = fingerprint_filter(_t(x["tables"]), _t(x["rid"]),
                                _t(x["idx"]), _t(x["clo"]))
    t2, d2 = ref.fingerprint_filter_ref(_t(x["tables"]), _t(x["rid"]),
                                        _t(x["idx"]), _t(x["clo"]))
    assert torch.equal(t1, t2) and torch.equal(d1, d2)
    s3, t3, d3 = tickfuse_response_path(
        *(_t(x[n]) for n in ("server_state", "tables", "rid", "idx", "clo",
                             "sid", "qlen")))
    assert d3.dtype == torch.bool and s3.shape == (G, 6)
    # launches count CUDA launches only
    assert fingerprint_filter.launches == 0
    assert tickfuse_response_path.launches == 0


def test_wrappers_check_their_inputs():
    x = _lanes(4)
    good = [_t(x[n]) for n in ("tables", "rid", "idx", "clo")]
    with pytest.raises(TypeError):
        fingerprint_filter(good[0].long(), *good[1:])
    with pytest.raises(ValueError):
        fingerprint_filter(good[0], good[1][:, :5], *good[2:])
    with pytest.raises(ValueError):
        fingerprint_filter(good[0][:, :, ::2], *good[1:])
    with pytest.raises(ValueError):
        tickfuse_response_path(_t(x["server_state"])[:3], good[0],
                               *good[1:], _t(x["sid"]), _t(x["qlen"]))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fingerprint_filter", "tickfuse"])
@pytest.mark.parametrize("shape", [(200, 32, 4, 1024, 6),
                                   (9, 32, 10, 1024, 24)],
                         ids=["default", "4-rack"])
def test_cuda_kernel_matches_plain_version(kernel, shape):
    """At the default sweep's shape and at the 4-rack fabric's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    x = filter_lanes(*shape, seed=5)
    names = ("tables", "rid", "idx", "clo") if kernel == "fingerprint_filter" \
        else ("server_state", "tables", "rid", "idx", "clo", "sid", "qlen")
    fn = fingerprint_filter if kernel == "fingerprint_filter" \
        else tickfuse_response_path
    plain = ref.fingerprint_filter_ref if kernel == "fingerprint_filter" \
        else ref.tickfuse_ref
    before = fn.launches
    got = fn(*(_t(x[n], "cuda") for n in names))
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*(_t(x[n], "cuda") for n in names))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())
