"""The single-host gang, the sharded feed and the Trainer's failures on a
mesh of threaded ranks, against the JAX package where it has the same
thing.

- ``device_batches(mesh=)`` gives each rank the rows ``shard_batch``
  gives it, batch after batch in order, as DTensors of the global shape
  on ``batch_sharding``; a host error reaches every rank at its batch;
- ``form_gang``'s -1 fill gives the JAX gang's axis sizes on as many
  devices, and ``put_batch`` each rank the rows the JAX gang's
  ``put_batch`` puts on the device at its mesh position;
- a host error on one rank alone is raised on every rank at its step
  (``HostDataError``), and every rank resumes from the same checkpoint;
- any other failure of one rank alone ends the run with ``RankError``
  (that rank's traceback) within the rank helper's timeout, never a
  hang;
- the session knows its rank and the world's size."""

import time

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor

import _torch_port_mesh_train as mt
from _torch_port_mesh_train import case  # noqa: F401 (the fixture)
from _torch_port_ranks import MESHES, port_mesh, ranks, world
from ray_tpu.parallel.gang import GangConfig as JGangConfig
from ray_tpu.parallel.gang import TpuGang as JTpuGang
from ray_tpu_torch.data import device_batches
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.parallel import RankError, form_gang, run_ranks
from ray_tpu_torch.train import TrainingFailedError, session, shard_batch
from ray_tpu_torch.train.trainer import HostDataError
from test_torch_port_trainer import FailingBatches


def _host_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 512, (4, 9)).astype(np.int32),
             "w": rng.standard_normal((4, 3)).astype(np.float32),
             "lr": np.float32(0.5 + i)} for i in range(n)]


# each mesh's block of rows per rank: ranks lie row-major over the mesh
# and the data axes (dp, fsdp) split the batch, outermost first
ROWS = {"dp2_tp2": lambda r: slice(2 * (r // 2), 2 * (r // 2) + 2),
        "dp2_fsdp2": lambda r: slice(r, r + 1),
        "dp2_sp2": lambda r: slice(2 * (r // 2), 2 * (r // 2) + 2)}


@pytest.mark.parametrize("name", ["dp2_tp2", "dp2_fsdp2", "dp2_sp2"])
@pytest.mark.parametrize("prefetch", [1, 3])
def test_device_batches_on_a_mesh_give_each_rank_shard_batch_rows(
        name, prefetch):
    host = _host_batches(5)

    def rank(r):
        mesh = port_mesh(name)
        out = []
        for got, h in zip(device_batches(iter(host), prefetch=prefetch,
                                         mesh=mesh), host):
            want = shard_batch(h, mesh)
            assert set(got) == set(h)
            for k, t in got.items():
                assert isinstance(t, DTensor)
                assert t.shape == want[k].shape
                assert t.placements == want[k].placements
                assert t.stride() == want[k].stride()
                assert torch.equal(t.to_local(), want[k].to_local())
            out.append(got["tokens"].to_local().clone())
        return out

    for r, rows in enumerate(ranks(rank, world(name))):
        assert len(rows) == 5
        for t, h in zip(rows, host):
            np.testing.assert_array_equal(t.numpy(),
                                          h["tokens"][ROWS[name](r)])


def test_device_batches_on_a_mesh_raise_a_host_error_at_its_batch():
    def host():
        for i, b in enumerate(_host_batches(6)):
            if i == 3:
                raise RuntimeError("host failed at 3")
            yield b

    def rank(r):
        feed = device_batches(host(), prefetch=2, mesh=port_mesh("dp2_tp2"))
        got = [float(next(feed)["lr"].to_local()) for _ in range(3)]
        with pytest.raises(RuntimeError, match="at 3"):
            next(feed)
        return got

    assert ranks(rank, 4) == [[0.5, 1.5, 2.5]] * 4


@pytest.mark.parametrize("axes", [{"dp": -1}, {"dp": -1, "tp": 2},
                                  {"fsdp": 2, "tp": -1}])
def test_form_gang_fills_like_the_jax_gang(axes):
    want = JTpuGang(JGangConfig(mesh_axes=dict(axes)),
                    devices=jax.devices("cpu")[:4])

    def rank(r):
        g = form_gang(axes, device="cpu")
        assert g.run(lambda a, b=0: a + b, 1, b=2) == 3
        return g.axis_sizes, g.num_devices, g.num_hosts

    assert ranks(rank, 4) == [(want.axis_sizes, 4, 1)] * 4


def test_gang_put_batch_gives_each_rank_the_jax_gangs_rows():
    axes = MESHES["dp2_tp2"][1]
    jg = JTpuGang(JGangConfig(mesh_axes=dict(axes)),
                  devices=jax.devices("cpu")[:4])
    host = _host_batches(1, seed=3)[0]
    jb = jg.put_batch({"tokens": host["tokens"]})["tokens"]
    devs = jg.mesh.devices
    want = {}
    for shard in jb.addressable_shards:
        pos = np.argwhere(devs == shard.device)[0]
        want[int(np.ravel_multi_index(tuple(pos), devs.shape))] = \
            np.asarray(shard.data)

    def rank(r):
        g = form_gang(axes, device="cpu")
        return g.put_batch(host)["tokens"].to_local().numpy()

    for r, rows in enumerate(ranks(rank, 4)):
        np.testing.assert_array_equal(rows, want[r])


def test_a_host_error_on_one_rank_restarts_every_rank(case, tmp_path):
    """Only rank 1's data fails at step 4: every rank raises
    ``HostDataError`` at step 4 and resumes from the step-3 checkpoint,
    and the run ends where the run without a failure ends."""
    want = mt.port_fit(case, "dp2", str(tmp_path / "clean"),
                       data=case[3], eval_fn=None)[0]
    errors = []

    def rank(r):
        data = (FailingBatches(case[3], mt.FAIL_AT) if r == 1
                else FailingBatches(case[3], fail_at=0))
        tr = mt.port_trainer(case, str(tmp_path / "run"), data=data,
                             mesh={"dp": 2}, params_logical=None,
                             eval_fn=None)
        real = tr._next_batch

        def spy(feed, step):
            try:
                return real(feed, step)
            except HostDataError as e:
                errors.append((r, step, str(e)))
                raise
        tr._next_batch = spy
        res = tr.fit()
        return mt.history(res), tr.start_step, data.passes

    got = ranks(rank, 2)
    assert sorted((r, step) for r, step, _ in errors) == [(0, 4), (1, 4)]
    assert all("at step 4 on rank(s) [1]" in e for _, _, e in errors)
    for hist, start, passes in got:
        assert (start, passes) == (3, 2)
        mt.assert_histories_close(hist[3:], want[0][3:])


def test_a_lone_rank_failure_ends_fit_with_rank_error(case, tmp_path):
    """A failure of rank 1 alone (its loss raises at step 2) is not
    retried on a mesh: rank 1's ``fit`` raises, the others are woken from
    the collective they wait in, and ``run_ranks`` raises ``RankError``
    with rank 1's traceback, long before its timeout."""
    _, tcfg, _, _, _ = case

    def rank(r):
        calls = [0]

        def loss(p, b, mesh=None, rules=None):
            calls[0] += 1
            if r == 1 and calls[0] == 2:
                raise RuntimeError("rank 1 fails alone")
            return tgpt.loss_fn(p, b, tcfg, mesh=mesh)

        mt.port_trainer(case, str(tmp_path), loss_fn=loss,
                        mesh={"dp": 2}, params_logical=None,
                        eval_fn=None, data=case[3]).fit()

    t0 = time.monotonic()
    with pytest.raises(RankError, match="rank 1 of 2 failed") as info:
        run_ranks(rank, 2, timeout=60)
    assert time.monotonic() - t0 < 30
    assert "rank 1 fails alone" in str(info.value)
    assert TrainingFailedError.__name__ in str(info.value)


def test_the_session_knows_its_rank_and_world(case, tmp_path):
    seen = []
    _, tcfg, _, _, _ = case

    def rank(r):
        def loss(p, b, mesh=None, rules=None):
            seen.append((r, session.get_world_rank(),
                         session.get_world_size()))
            return tgpt.loss_fn(p, b, tcfg, mesh=mesh)

        mt.port_trainer(case, str(tmp_path), loss_fn=loss, mesh={"dp": 2},
                        params_logical=None, eval_fn=None, data=case[3],
                        num_steps=1).fit()

    ranks(rank, 2)
    assert sorted(seen) == [(0, 0, 2), (1, 1, 2)]


def test_the_gang_and_the_mesh_trainer_need_a_card_unless_told(
        case, monkeypatch):
    """``device=None`` is the CUDA card: without one, forming the gang
    and a Trainer on mesh axes raise, as every entry point does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def rank(r):
        for call in (lambda: form_gang({"dp": -1}),
                     lambda: mt.port_trainer(case, "unused", mesh={"dp": 1},
                                             device=None)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
        return form_gang({"dp": -1}, device="cpu").axis_sizes

    assert ranks(rank, 1) == [{"dp": 1}]
