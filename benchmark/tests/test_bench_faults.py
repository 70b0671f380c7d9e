"""A run whose timed path is broken underneath comes out not correct:
the harness is driven past its look for a card on the CPU, with each
fault its cell can have planted in the port's step, and the check of
the window's outputs against the reference must read false."""

import time

import numpy as np
import pytest
import torch
from mini import mini_plan

from lidarseg3d_torch.apis import train as api
from segbench import cell

SEED = 2**31 + 1234


def run(plan):
    return cell.run(plan, SEED, 0.3, False, torch.device("cpu"),
                    time.perf_counter(), log=lambda m: None)


def unchanged_state(monkeypatch):
    """The step computes its gradients and returns the state as it was."""
    def apply_gradients(state, optimizer):
        state.step += 1
        return torch.zeros(())
    monkeypatch.setattr(api, "apply_gradients", apply_gradients)


def half_batch(monkeypatch):
    """Half of the batch's rows reach the step; its means run over them."""
    to_device = api.example_to_device

    def first_half(batch, device):
        B = batch["points"].shape[0]
        keep = {k: v[:max(1, B // 2)] if isinstance(v, np.ndarray) else v
                for k, v in batch.items()}
        return to_device(keep, device)
    monkeypatch.setattr(api, "example_to_device", first_half)


def altered_answer(monkeypatch):
    """The eval step's labels (and the softmax a TTA frame's labels come
    from) shifted by one class where they are produced."""
    make = api.make_eval_step

    def make_eval_step(model, input_shape):
        step = make(model, input_shape)

        def broken(state, batch):
            out = dict(step(state, batch))
            out["pred_point_sem_labels"] = (out["pred_point_sem_labels"]
                                            + 1) % 20
            out["point_softmax"] = torch.roll(out["point_softmax"], 1, -1)
            return out
        return broken
    monkeypatch.setattr(api, "make_eval_step", make_eval_step)


FAULTS = [
    ("mseg3d-semkitti.train", unchanged_state),
    ("mseg3d-semkitti.train", half_batch),
    ("sdseg3d-semkitti.train", unchanged_state),
    ("sdseg3d-semkitti.train", half_batch),
    ("mseg3d-semkitti.infer", altered_answer),
    ("sdseg3d-semkitti.infer-tta", altered_answer),
    ("sdseg3d-semkitti.infer-tta", half_batch),
]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__}" for w, f in FAULTS])
def test_fault_is_not_correct(workload, fault, tmp_path, monkeypatch,
                              cpu_threads):
    plan = mini_plan(workload, tmp_path)
    fault(monkeypatch)
    res = run(plan)
    assert not res["correct"], res["checks"]
