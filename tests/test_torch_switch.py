"""The port's batched data plane ≡ ``repro.core.switch_jax`` and its oracles.

Inputs are drawn with numpy from a seed and handed to both sides; the port
runs every config of a batch at once (leading ``G`` axis), the reference
one switch at a time.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import switch_jax as sw
from repro.core.tables import GroupTable as RefGroupTable
from repro.core.tables import fingerprint_hash as ref_fingerprint_hash
from repro_torch.core import switch as tsw
from repro_torch.core.tables import GroupTable, fingerprint_hash
from repro_torch.scatter import scatter_add_drop, scatter_last
from test_torch_common import _one_torch_thread  # noqa: F401


G = 4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n_servers", [2, 4, 6, 7])
def test_group_pairs_match_reference_order(n_servers):
    assert np.array_equal(GroupTable(n_servers).pairs,
                          RefGroupTable(n_servers).pairs)
    assert np.array_equal(tsw.group_pairs_array(n_servers).numpy(),
                          np.asarray(sw.group_pairs_array(n_servers)))


def test_fingerprint_hash_matches():
    rng = np.random.default_rng(0)
    rid = np.concatenate([rng.integers(1, 2 ** 31 - 1, 500),
                          [1, 2, 2 ** 24 - 1, 2 ** 31 - 1]]).astype(np.int32)
    for n_slots in (32, 1024, 2 ** 13):
        want = np.asarray(sw.fingerprint_hash_jax(jnp.asarray(rid), n_slots))
        got = tsw.fingerprint_hash(_t(rid), n_slots).numpy()
        assert np.array_equal(got, want)
        assert np.array_equal(fingerprint_hash(rid, n_slots),
                              ref_fingerprint_hash(rid, n_slots))


@pytest.mark.parametrize("seed", range(3))
def test_dispatch_tick_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    n_servers, batch = 6, 24
    gp = np.asarray(sw.group_pairs_array(n_servers))
    qlens = rng.integers(0, 3, (G, n_servers)).astype(np.int32)
    grp = rng.integers(0, gp.shape[0], (G, batch))
    seq0 = rng.integers(0, 100, G).astype(np.int32)
    state = tsw.init_switch_state(G, n_servers, 2, 64)
    state = state._replace(seq=_t(seq0), server_state=_t(qlens))
    new, res = tsw.dispatch_tick(state, tsw.group_pairs_array(n_servers),
                                 _t(grp))
    for g in range(G):
        seq2, rid, s1, s2, cloned = sw.dispatch_tick_oracle(
            int(seq0[g]), qlens[g], gp, grp[g])
        assert int(new.seq[g]) == seq2
        assert np.array_equal(res.req_id[g].numpy(), rid)
        assert np.array_equal(res.dst1[g].numpy(), s1)
        assert np.array_equal(res.dst2[g].numpy(), s2)
        assert np.array_equal(res.cloned[g].numpy(), cloned)


def _responses(rng, batch, n_servers, n_tables=2, id_hi=30):
    rid = rng.integers(1, id_hi, (G, batch)).astype(np.int32)
    idx = rng.integers(0, n_tables, (G, batch)).astype(np.int32)
    clo = rng.integers(0, 3, (G, batch)).astype(np.int32)
    sid = rng.integers(0, n_servers, (G, batch)).astype(np.int32)
    qlen = rng.integers(0, 9, (G, batch)).astype(np.int32)
    return rid, idx, clo, sid, qlen


@pytest.mark.parametrize("seed", range(4))
def test_filter_tick_matches_oracle(seed):
    """Lane-sequential filter, repeated ids and repeated servers included."""
    rng = np.random.default_rng(seed)
    n_servers, n_slots, batch = 4, 32, 40
    rid, idx, clo, sid, qlen = _responses(rng, batch, n_servers)
    tables0 = rng.integers(0, 30, (G, 2, n_slots)).astype(np.int32)
    sstate0 = rng.integers(0, 5, (G, n_servers)).astype(np.int32)
    state = tsw.SwitchState(seq=torch.zeros(G, dtype=torch.int32),
                            server_state=_t(sstate0.copy()),
                            filter_tables=_t(tables0.copy()))
    new, res = tsw.filter_tick(state, *map(_t, (rid, idx, clo, sid, qlen)))
    for g in range(G):
        t_want, s_want, d_want = sw.filter_tick_oracle(
            tables0[g], sstate0[g], rid[g], idx[g], clo[g], sid[g], qlen[g])
        assert np.array_equal(new.filter_tables[g].numpy(), t_want)
        assert np.array_equal(new.server_state[g].numpy(), s_want)
        assert np.array_equal(res.drop[g].numpy(), d_want)
        # the reference's own scan form agrees as well
        ref_state = sw.SwitchState(seq=jnp.int32(0),
                                   server_state=jnp.asarray(sstate0[g]),
                                   filter_tables=jnp.asarray(tables0[g]))
        ref_new, ref_res = sw.filter_tick(ref_state, *map(
            jnp.asarray, (rid[g], idx[g], clo[g], sid[g], qlen[g])))
        assert np.array_equal(np.asarray(ref_res.drop), d_want)


@pytest.mark.parametrize("seed", range(4))
def test_filter_tick_vectorized_matches_reference(seed):
    """Bit-exact with ``switch_jax.filter_tick_vectorized``, padding lanes
    and different-id slot collisions (few slots) included."""
    rng = np.random.default_rng(100 + seed)
    n_servers, n_slots, batch = 5, 8, 32
    rid, idx, clo, sid, qlen = _responses(rng, batch, n_servers, id_hi=20)
    active = rng.random((G, batch)) < 0.8
    tables0 = rng.integers(0, 20, (G, 2, n_slots)).astype(np.int32)
    sstate0 = rng.integers(0, 5, (G, n_servers)).astype(np.int32)
    state = tsw.SwitchState(seq=torch.zeros(G, dtype=torch.int32),
                            server_state=_t(sstate0.copy()),
                            filter_tables=_t(tables0.copy()))
    new, res = tsw.filter_tick_vectorized(
        state, *map(_t, (rid, idx, clo, sid, qlen)), _t(active))
    for g in range(G):
        ref_state = sw.SwitchState(seq=jnp.int32(0),
                                   server_state=jnp.asarray(sstate0[g]),
                                   filter_tables=jnp.asarray(tables0[g]))
        ref_new, ref_res = sw.filter_tick_vectorized(
            ref_state, *map(jnp.asarray, (rid[g], idx[g], clo[g], sid[g],
                                          qlen[g], active[g])))
        assert np.array_equal(new.filter_tables[g].numpy(),
                              np.asarray(ref_new.filter_tables))
        assert np.array_equal(new.server_state[g].numpy(),
                              np.asarray(ref_new.server_state))
        assert np.array_equal(res.drop[g].numpy(), np.asarray(ref_res.drop))


def test_vectorized_divergence_is_reproduced():
    """The reference's documented divergence: an unrelated insert landing
    on a parked fingerprint's slot in the same tick.  The sequential filter
    forwards the owner's response; the vectorized form drops it."""
    n_slots = 1024
    slot = lambda r: int(tsw.fingerprint_hash(torch.tensor([r]), n_slots))
    parked = 5
    other = next(r for r in range(6, 100000) if slot(r) == slot(parked))
    tables = np.zeros((1, 1, n_slots), np.int32)
    tables[0, 0, slot(parked)] = parked
    rid = np.array([[other, parked]], np.int32)
    zeros = np.zeros_like(rid)
    ones = np.ones_like(rid)
    args = (rid, zeros, ones, zeros, zeros)

    def fresh():
        return tsw.SwitchState(seq=torch.zeros(1, dtype=torch.int32),
                               server_state=torch.zeros((1, 1),
                                                        dtype=torch.int32),
                               filter_tables=_t(tables.copy()))

    _, seq_res = tsw.filter_tick(fresh(), *map(_t, args))
    _, vec_res = tsw.filter_tick_vectorized(fresh(), *map(_t, args))
    ref_state = sw.SwitchState(seq=jnp.int32(0),
                               server_state=jnp.zeros(1, jnp.int32),
                               filter_tables=jnp.asarray(tables[0]))
    _, ref_vec = sw.filter_tick_vectorized(ref_state,
                                           *map(jnp.asarray, (a[0] for a
                                                              in args)))
    assert seq_res.drop.tolist() == [[False, False]]
    assert vec_res.drop.tolist() == [[False, True]]
    assert np.array_equal(vec_res.drop[0].numpy(), np.asarray(ref_vec.drop))


def test_wipe_zeroes_all_soft_state():
    state = tsw.SwitchState(seq=torch.full((G,), 9, dtype=torch.int32),
                            server_state=torch.ones((G, 3),
                                                    dtype=torch.int32),
                            filter_tables=torch.ones((G, 2, 8),
                                                     dtype=torch.int32))
    w = tsw.wipe(state)
    assert all(int(t.abs().sum()) == 0 for t in w)
    assert int(state.seq.sum()) == 9 * G          # the input is untouched


def test_scatter_last_lane_wins_and_drops():
    """Repeated indices resolve to the last valid lane; invalid and
    out-of-range lanes write nothing — ``.at[].set(mode="drop")``."""
    rng = np.random.default_rng(7)
    n, lanes = 6, 20
    idx = rng.integers(-2, n + 2, (G, lanes))
    val = rng.integers(1, 100, (G, lanes)).astype(np.int32)
    valid = rng.random((G, lanes)) < 0.7
    target = rng.integers(0, 5, (G, n)).astype(np.int32)
    want = target.copy()
    for g in range(G):
        for j in range(lanes):
            if valid[g, j] and 0 <= idx[g, j] < n:
                want[g, idx[g, j]] = val[g, j]
    got = scatter_last(_t(target.copy()), _t(idx), _t(val), _t(valid))
    assert np.array_equal(got.numpy(), want)
    # rows with a trailing payload axis
    rows = rng.random((G, lanes, 3)).astype(np.float32)
    tgt = np.zeros((G, n, 3), np.float32)
    want = tgt.copy()
    for g in range(G):
        for j in range(lanes):
            if valid[g, j] and 0 <= idx[g, j] < n:
                want[g, idx[g, j]] = rows[g, j]
    got = scatter_last(_t(tgt), _t(idx), _t(rows), _t(valid))
    assert np.array_equal(got.numpy(), want)
    # the add form
    add = scatter_add_drop(_t(target.copy()), _t(idx), 1, _t(valid))
    want = target.copy()
    for g in range(G):
        for j in range(lanes):
            if valid[g, j] and 0 <= idx[g, j] < n:
                want[g, idx[g, j]] += 1
    assert np.array_equal(add.numpy(), want)
