"""The port's checkpoints (``training/checkpoint.py``, the counterpart of
the JAX package's Orbax ``CheckpointManager``): a training state saved and
written back in place bit for bit, zero-size tensors included; the
``keep`` and ``save_interval_steps`` policy as Orbax applies it; and a
resumed ``train_sort_device`` run bit-equal to an uninterrupted one, also
when the state is written back into the live objects of a run that went
on (in place: a captured step keeps the addresses it captured)."""

import os

import numpy as np
import pytest
import torch

import graphnets_tpu_torch as pt
from graphnets_tpu.training.checkpoint import \
    CheckpointManager as JaxCheckpointManager

DIMS = (16, 16, 16)
CFG = pt.SortTaskConfig(batch_size=2)


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: one intra-op thread is faster, and several test
    workers on one machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(seed, steps=0):
    """A model, its AdamW (with state after ``steps`` eager steps) and a
    batch generator, as a ``TrainState``."""
    model = pt.EncodeProcessDecode((0, 100, 0), DIMS, (2, 2, 0), n_cores=1,
                                   device="cpu",
                                   generator=torch.Generator().manual_seed(seed))
    opt = pt.adamw(model.parameters())
    gen = torch.Generator().manual_seed(seed + 100)
    step = pt.make_sort_device_step(pt.TrainState(model, opt, 0, (gen,)),
                                    CFG)
    for _ in range(steps):
        step()
    return pt.TrainState(model, opt, steps, (gen,))


def _assert_same(a, b):
    assert a.step == b.step
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert p.shape == q.shape and torch.equal(p, q), n
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(sb["state"][i][k])), (i, k)
    for ga, gb in zip(a.generators, b.generators):
        assert torch.equal(ga.get_state(), gb.get_state())


def test_round_trip_in_place_with_zero_size_tensors(tmp_path):
    saved = _state(0, steps=2)
    zero = [n for n, p in saved.model.named_parameters() if p.numel() == 0]
    assert zero, "the sort model has zero-width parameters"
    mgr = pt.CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(2, saved, wait=True) and mgr.latest_step() == 2
    target = _state(1, steps=1)        # other values, the same structure
    params = [p for p in target.model.parameters()]
    moments = [t for st in target.optimizer.state.values()
               for t in st.values()]
    restored = mgr.restore(target)
    _assert_same(restored, saved)
    # In place: the same tensors hold the restored values.
    assert [p for p in restored.model.parameters()] == params
    assert all(any(t is m for m in moments)
               for st in restored.optimizer.state.values()
               for t in st.values())
    for n, p in restored.model.named_parameters():
        if n in zero:
            assert p.numel() == 0
    # A fresh optimizer (no state yet) takes the saved state.
    fresh = _state(2)
    _assert_same(mgr.restore(fresh), saved)
    mgr.wait()
    mgr.close()
    assert pt.restore_checkpoint(str(tmp_path / "ckpt"), _state(3)).step == 2
    with pytest.raises(FileNotFoundError):
        pt.CheckpointManager(str(tmp_path / "empty")).restore(_state(4))


def test_a_wrong_structure_is_refused(tmp_path):
    mgr = pt.CheckpointManager(str(tmp_path))
    mgr.save(0, _state(0, steps=1))
    other = pt.EncodeProcessDecode((0, 100, 0), (8, 8, 8), (2, 2, 0),
                                   n_cores=1, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(pt.TrainState(other, pt.adamw(other.parameters()), 0,
                                  (torch.Generator(),)))
    # A live optimizer whose state does not match the saved one is not
    # replaced (a captured step would keep updating the old tensors), and
    # nothing of the live state is written before the refusal.
    before = pt.CheckpointManager(str(tmp_path / "before"))
    before.save(0, _state(0))
    live = _state(1, steps=1)
    values = [t.clone() for t in live.model.parameters()] + [
        t.clone() for st in live.optimizer.state.values() for t in st.values()]
    with pytest.raises(ValueError, match="fresh optimizer"):
        before.restore(live)
    assert all(torch.equal(a, b) for a, b in zip(values, list(
        live.model.parameters()) + [t for st in live.optimizer.state.values()
                                    for t in st.values()]))


def test_keep_and_interval_follow_orbax(tmp_path):
    """The same sequence of saves through both packages' managers keeps
    the same steps and says True / False alike: a first save always, later
    ones on multiples of the interval and newer than the latest, the
    newest ``keep`` kept."""
    import jax.numpy as jnp
    tree = {"w": jnp.ones((2, 3)), "z": jnp.zeros((1,))}
    state = _state(0)
    for keep, interval in ((2, 1), (3, 4)):
        dj = str(tmp_path / f"j{keep}")
        dp = str(tmp_path / f"p{keep}")
        mj = JaxCheckpointManager(dj, keep=keep,
                                  save_interval_steps=interval)
        mp = pt.CheckpointManager(dp, keep=keep,
                                  save_interval_steps=interval)
        for step in (1, 2, 4, 3, 5, 8, 9, 12, 16, 16):
            said_j = mj.save(step, tree, wait=True)
            said_p = mp.save(step, state, wait=True)
            assert said_p == said_j, (keep, interval, step)
        mj.wait()
        assert mp.all_steps() == list(mj._mgr.all_steps()), (keep, interval)
        assert mp.latest_step() == mj.latest_step()
        mj.close()
        assert sorted(os.listdir(dp)) == sorted(map(str, mp.all_steps()))


def test_resumed_run_is_bit_equal(tmp_path):
    """Two chunks straight through against one chunk, a checkpoint at the
    chunk boundary, and the next chunk from the restored state: once into
    a fresh model and optimizer, once into the model and optimizer of the
    run that already went on (written in place)."""
    kw = dict(cfg=CFG, core_dims=DIMS, n_cores=1, chunk=2, seed=4,
              device="cpu")
    full = pt.train_sort_device(steps=4, **kw)
    half = pt.train_sort_device(steps=2, **kw)
    mgr = pt.CheckpointManager(str(tmp_path), keep=1)
    assert mgr.save(half.state.step, half.state)
    fresh = mgr.restore(_state(9))
    rest = pt.train_sort_device(steps=2, state=fresh, **kw)
    _assert_same(rest.state, full.state)
    assert rest.metrics == full.metrics
    # The run that went on, rewound into its live objects.
    more = pt.train_sort_device(steps=2, state=half.state, **kw)
    assert more.state.step == 4
    back = mgr.restore(more.state)
    assert back.step == 2 and back.model is half.model
    again = pt.train_sort_device(steps=2, state=back, **kw)
    _assert_same(again.state, full.state)
    assert np.isfinite(list(again.metrics.values())).all()
