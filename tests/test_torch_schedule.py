"""Learning-rate schedules in the port (``training/schedules``) against
optax's, and the trainers that take them.

The schedule's values against ``optax.warmup_cosine_decay_schedule`` at
the step counts where its pieces meet (within 2 f32 ulps: both are f32
expressions of the same formula); 30 f32 steps of ``make_train_step`` +
``adamw(schedule)`` against JAX's ``make_train_step`` + ``optax.adamw``
of the same schedule on the same ``get_batch`` batches (the port's
``get_batch`` is bit-equal to JAX's), parameters within 1e-5 of their
largest magnitude, each step's loss within 1e-4 relative (the two f32
trajectories part in the last bits: 1.1e-5 by step 17);
``train_sort_device`` evaluating the schedule at each
step's count; a resume from ``CheckpointManager`` going on from the saved
count, bit-equal to a run straight through.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import graphnets_tpu_torch as pt
from graphnets_tpu.data.sort_task import (SortTaskConfig, get_batch,
                                          sort_pad_spec)
from graphnets_tpu.models.encode_process_decode import \
    EncodeProcessDecode as JaxEncodeProcessDecode
from graphnets_tpu.training.train import TrainState, make_train_step
from graphnets_tpu_torch.training.schedules import (
    constant_schedule, warmup_cosine_decay_schedule)

# benchmarks/run_flagship.py's recipe, and a short one for the trajectory.
FLAGSHIP = (0.0, 3e-4, 500, 20_000, 1e-5)
SHORT = (0.0, 1e-3, 10, 30, 1e-5)


@pytest.mark.parametrize("args", [FLAGSHIP, SHORT, (1e-4, 2e-3, 0, 50, 0.0)])
def test_warmup_cosine_matches_optax(args):
    init, peak, warmup, decay, end = args
    ours = warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
    ref = optax.warmup_cosine_decay_schedule(init, peak, warmup, decay,
                                             end_value=end)
    for count in sorted({0, max(warmup - 1, 0), warmup, warmup + 1,
                         (warmup + decay) // 2, decay - 1, decay,
                         decay + 100}):
        got = ours(torch.tensor(float(count)))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_array_max_ulp(
            got.numpy(), np.asarray(ref(count), np.float32), maxulp=2)


def test_constant_schedule_and_device():
    got = constant_schedule(3e-4)(torch.tensor(7.0))
    assert got.dtype == torch.float32 and float(got) == np.float32(3e-4)
    with pytest.raises(ValueError, match="exceed"):
        warmup_cosine_decay_schedule(0.0, 1.0, 10, 10)


def test_adamw_float_lr_is_unchanged():
    """A float rate keeps the optimizer as it was: a float in its group,
    no hook."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = pt.adamw([p], 3e-4)
    assert opt.param_groups[0]["lr"] == 3e-4
    assert not opt._optimizer_step_pre_hooks


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def test_thirty_steps_match_optax():
    cfg = SortTaskConfig(vocab_size=8, min_nodes=2, max_nodes=4,
                         batch_size=2)
    model_j = JaxEncodeProcessDecode((0, 8, 0), (16, 16, 16), (2, 2, 0),
                                     n_cores=1)
    opt_j = optax.adamw(optax.warmup_cosine_decay_schedule(
        *SHORT[:4], end_value=SHORT[4]))
    state = TrainState.create(model_j, opt_j, jax.random.PRNGKey(4))
    model_p = pt.EncodeProcessDecode((0, 8, 0), (16, 16, 16), (2, 2, 0),
                                     n_cores=1, device="cpu")
    pt.from_jax_params(jax.tree_util.tree_map(np.asarray, state.params),
                       model_p)
    opt_p = pt.adamw(model_p.parameters(),
                     warmup_cosine_decay_schedule(*SHORT))
    step_j = jax.jit(make_train_step(model_j, opt_j))
    step_p = pt.make_train_step(model_p, opt_p)
    rng_j, rng_p = np.random.default_rng(5), np.random.default_rng(5)
    pcfg = pt.SortTaskConfig(vocab_size=8, min_nodes=2, max_nodes=4,
                             batch_size=2)
    for i in range(30):
        x, y = get_batch(rng_j, cfg, sort_pad_spec(cfg))
        state, m_j = step_j(state, x, y)
        m_p = step_p(*pt.get_batch(rng_p, pcfg, pt.sort_pad_spec(pcfg),
                                   device="cpu"))
        np.testing.assert_allclose(float(m_p["loss"]), float(m_j["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
    want = warmup_cosine_decay_schedule(*SHORT)(torch.tensor(29.0))
    assert torch.equal(opt_p.param_groups[0]["lr"], want)
    ref = _flat(jax.tree_util.tree_map(np.asarray, state.params))
    for n, p in model_p.named_parameters():
        got = p.detach().numpy()
        assert np.abs(got - ref[n]).max(initial=0.0) <= 1e-5 * np.abs(
            ref[n]).max(initial=1e-30), n


def test_train_sort_device_follows_the_schedule():
    """Each step evaluates the schedule at its count before the update, so
    step 0 uses ``schedule(0)``."""
    sched = warmup_cosine_decay_schedule(0.0, 1e-3, 3, 8, 1e-5)
    seen = []

    def spy(count):
        seen.append(float(count))
        return sched(count)

    cfg = pt.SortTaskConfig(vocab_size=8, min_nodes=2, max_nodes=4,
                            batch_size=2)
    res = pt.train_sort_device(steps=6, cfg=cfg, core_dims=(16, 16, 16),
                               n_cores=1, learning_rate=spy, chunk=2,
                               device="cpu")
    assert seen == [float(i) for i in range(6)]
    lr = res.optimizer.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and torch.equal(
        lr, sched(torch.tensor(5.0)))
    assert float(res.optimizer.state[next(iter(
        res.model.parameters()))]["step"]) == 6


def test_resume_continues_the_schedule(tmp_path):
    """A checkpoint after 3 steps restored into a fresh model and
    optimizer: the 4th step writes ``schedule(3)`` and ends bit-equal to 4
    steps straight through."""
    sched = warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10, 1e-5)
    cfg = pt.SortTaskConfig(vocab_size=8, min_nodes=2, max_nodes=4,
                            batch_size=2)
    rng = np.random.default_rng(9)
    batches = [pt.get_batch(rng, cfg, pt.sort_pad_spec(cfg), device="cpu")
               for _ in range(4)]

    def fresh():
        model = pt.EncodeProcessDecode((0, 8, 0), (16, 16, 16), (2, 2, 0),
                                       n_cores=1, device="cpu")
        opt = pt.adamw(model.parameters(), sched)
        return pt.TrainState(model, opt, 0), pt.make_train_step(model, opt)

    straight, step = fresh()
    for b in batches:
        step(*b)
    first, step = fresh()
    for b in batches[:3]:
        step(*b)
    first.step = 3
    mgr = pt.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, first)
    resumed, step = fresh()
    lr = resumed.optimizer.param_groups[0]["lr"]
    resumed = mgr.restore(resumed)
    assert resumed.optimizer.param_groups[0]["lr"] is lr
    step(*batches[3])
    assert torch.equal(lr, sched(torch.tensor(3.0)))
    for p, q in zip(resumed.model.parameters(), straight.model.parameters()):
        assert torch.equal(p, q)
