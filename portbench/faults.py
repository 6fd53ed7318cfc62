"""Faults planted under the timed path, which ``correct`` has to catch
(``portbench/tests/test_portbench_harness.py`` on the CPU,
``portbench.calibrate`` on the card). Each wraps the step the window
drives: a train fault takes (step, state, cfg), an eval fault takes
(step). ``run.run_cell`` takes a fault by its name here."""
from __future__ import annotations


def _half(batch):
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


def train_unchanged(step, state, cfg):
    """The step computes but leaves the model and the optimizer as they
    were."""
    def f(batch):
        saved = {k: v.detach().clone()
                 for k, v in state.model.state_dict().items()}
        out = step(batch)
        state.model.load_state_dict(saved)
        state.optimizer.state.clear()
        return out
    return f


def train_no_exchange(step, state, cfg):
    """The data-parallel step with its exchange after the backward left
    out: each rank updates from its own gradients and reports its own
    metrics (``parallel/dp_step.py``'s reduction a no-op on every rank,
    which keeps the ranks' collectives matched)."""
    from rangedet_tpu_torch.parallel import dp_step

    def f(batch):
        reduce = dp_step.all_reduce_
        dp_step.all_reduce_ = lambda tensors, group, mean=False: None
        try:
            return step(batch)
        finally:
            dp_step.all_reduce_ = reduce
    return f


def train_half_batch(step, state, cfg):
    """Half of the batch left out: the losses' means over the rest."""
    return lambda batch: step(_half(batch))


def eval_half_batch(step):
    """The eval step over half of the batch's frames."""
    return lambda batch: step(_half(batch))


def eval_altered_box(step):
    """One box of every frame moved by 10 m where the step produces
    it."""
    def f(batch):
        out = step(batch)
        for r in out.values():
            r["boxes"] = r["boxes"].clone()
            r["boxes"][..., 0, 0] += 10.0
        return out
    return f


TRAIN = {"unchanged": train_unchanged, "half_batch": train_half_batch,
         "no_exchange": train_no_exchange}
EVAL = {"half_batch": eval_half_batch, "altered_box": eval_altered_box}
