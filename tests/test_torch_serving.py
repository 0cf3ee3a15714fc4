"""The port's serving tier (``repro_torch.serve``) against the JAX
reference's, on the CPU: the same qwen2.5-3b smoke weights (carried across
by ``repro_torch.models.convert``), the same dispatcher seed and workload,
and the reference's own set-up (``tests/test_serving.py``: 3 replicas of 2
slots, ``s_max`` 64, 256 filter slots).  The dispatcher draws from the same
numpy stream, and the replicas' greedy tokens agree, so the two tiers must
give identical ``ServeStats`` and identical completion tokens.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import family_of as ref_family_of
from repro.serve import DecodeReplica as RefReplica
from repro.serve import NetCloneServer as RefServer
from repro_torch.configs import get_config
from repro_torch.core.header import CLO_CLONE, CLO_NONE
from repro_torch.kernels.fingerprint_filter import fingerprint_filter
from repro_torch.models import convert, lm
from repro_torch.serve import DecodeReplica, NetCloneServer, ServeRequest
from test_torch_common import _one_torch_thread  # noqa: F401


ARCH = "qwen2.5-3b"
POLICIES = ["baseline", "netclone", "netclone+racksched", "c-clone"]


@pytest.fixture(scope="module")
def weights():
    cfg_r = ref_get_config(ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True)
    p_ref = ref_family_of(cfg_r).init_params(cfg_r, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, p_ref)
    return cfg_r, cfg, p_ref, convert.params_from_numpy(cfg, tree)


def _workload(cfg, n, horizon, seed=0):
    rng = np.random.default_rng(seed)
    return [(int(t), rng.integers(0, cfg.vocab_size, 3).astype(np.int32))
            for t in np.sort(rng.integers(0, horizon, n))]


def _run(replica_cls, server_cls, cfg, params, policy, wl, seed, straggler,
         **dev):
    reps = [replica_cls(cfg, params, sid=i, n_slots=2, s_max=64, **dev)
            for i in range(3)]
    if straggler:
        reps[1].inject_slowdown(straggler)
    srv = server_cls(reps, policy=policy, n_slots=256, seed=seed, **dev)
    stats = srv.run(wl, max_new_tokens=3, max_ticks=300)
    return stats, {rid: c.tokens.tolist() for rid, c in srv._done.items()}


@pytest.mark.parametrize("straggler", [0, 12], ids=["steady", "straggler"])
@pytest.mark.parametrize("policy", POLICIES)
def test_server_matches_reference(weights, policy, straggler):
    cfg_r, cfg, p_ref, p = weights
    wl = _workload(cfg, 14, 12, seed=3)
    want, want_tok = _run(RefReplica, RefServer, cfg_r, p_ref, policy, wl,
                          seed=3, straggler=straggler)
    launches = fingerprint_filter.launches
    got, got_tok = _run(DecodeReplica, NetCloneServer, cfg, p, policy, wl,
                        seed=3, straggler=straggler, device="cpu")
    assert fingerprint_filter.launches == launches   # no card, no launch
    assert got.n_completed == want.n_completed == 14
    assert got.latencies_ticks == want.latencies_ticks
    for f in ("n_cloned", "n_filtered", "n_clone_drops"):
        assert getattr(got, f) == getattr(want, f), f
    assert got_tok == want_tok
    if policy in ("netclone", "c-clone"):
        assert got.n_cloned > 0


def test_replica_contract(weights):
    """The reference's replica contract: CLO=2 drop on a queue with waiting
    requests only, the empty-prompt error, and the post-dequeue STATE."""
    _, cfg, _, p = weights
    rep = DecodeReplica(cfg, p, sid=0, n_slots=1, s_max=64, device="cpu")
    z = np.zeros(2, np.int32)
    assert rep.submit(ServeRequest(1, z, 1, clo=CLO_NONE))
    assert rep.submit(ServeRequest(2, z, 1, clo=CLO_CLONE))   # admittable
    assert rep.queue_len == 1
    assert not rep.submit(ServeRequest(3, z, 1, clo=CLO_CLONE))
    assert rep.n_clone_drops == 1
    with pytest.raises(ValueError, match="at least one token"):
        rep.submit(ServeRequest(4, np.zeros(0, np.int32), 1))
    done = []
    for t in range(8):
        done += rep.tick(t)
    assert [c.req_id for c in done] == [1, 2]
    assert [c.state for c in done] == [0, 0]


def test_launch_serve_runs_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    serve.main(["--requests", "6", "--horizon", "10", "--straggler", "5"],
               device="cpu")
    out = capsys.readouterr().out
    assert "completed=6/6" in out and "cloned=" in out


def test_entry_points_raise_without_a_card(weights):
    """With no device given, the replica, the server and prefill run on
    CUDA; without a card they raise instead of running on the CPU."""
    _, cfg, _, p = weights
    if torch.cuda.is_available():
        rep = DecodeReplica(cfg, lm.init_params(cfg, 0), sid=0)
        assert rep.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeReplica(cfg, p, sid=0)
    rep = DecodeReplica(cfg, p, sid=0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NetCloneServer([rep, rep])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.prefill(cfg, p, np.zeros((1, 4), np.int32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_params(cfg, 0)

