"""The port's checkpointing (``repro_torch.checkpoint``): the seven cases
of ``tests/test_checkpoint.py`` on the port's trees (tensors in nested
dicts and tuples) — atomic roundtrip, retention, corruption tolerance,
shape and leaf-count mismatches, the async writer, and train-resume
determinism through the port's train step."""

import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (
    AsyncCheckpointer, latest_checkpoint, restore_checkpoint,
    save_checkpoint)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(4, 8, generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.int32),
                       "h": torch.randn(3, generator=g).bfloat16()},
            "scalar": torch.tensor(3.5)}


def _equal(a, b) -> None:
    leaves = lambda t: [t["w"], t["nested"]["b"], t["nested"]["h"],
                        t["scalar"]]
    for x, y in zip(leaves(a), leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_roundtrip(tmp_path):
    t = _tree()
    path = save_checkpoint(str(tmp_path), 7, t)
    target = {"w": torch.zeros(4, 8),
              "nested": {"b": torch.zeros(5, dtype=torch.int32),
                         "h": torch.zeros(3, dtype=torch.bfloat16)},
              "scalar": torch.tensor(0.0)}
    step, restored = restore_checkpoint(path, target)
    assert step == 7
    _equal(restored, t)


def test_latest_and_retention(tmp_path):
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, _tree(), keep=3)
    assert latest_checkpoint(str(tmp_path)).endswith("step_0000000005")
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(kept) == 3


def test_partial_checkpoint_ignored(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    # simulate a crashed writer: tmp dir + a dir without manifest
    os.makedirs(tmp_path / "step_0000000009.tmp")
    os.makedirs(tmp_path / "step_0000000008")
    assert latest_checkpoint(str(tmp_path)).endswith("step_0000000001")


def test_shape_mismatch_rejected(tmp_path):
    path = save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2, 2)})
    with pytest.raises(ValueError):
        restore_checkpoint(path, {"w": torch.zeros(3, 3)})


def test_leaf_count_mismatch_rejected(tmp_path):
    path = save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2)})
    with pytest.raises(ValueError):
        restore_checkpoint(path, {"w": torch.zeros(2), "x": torch.zeros(2)})


def test_async_checkpointer(tmp_path):
    """The writer gets a host copy made at ``save``: a later in-place
    update of the tree does not reach the checkpoint."""
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (10, 20):
        t = _tree(s)
        ck.save(s, t)
        t["w"].zero_()
    ck.close()
    assert latest_checkpoint(str(tmp_path)).endswith("step_0000000020")
    step, restored = restore_checkpoint(latest_checkpoint(str(tmp_path)),
                                        _tree())
    assert step == 20
    _equal(restored, _tree(20))


def test_resume_determinism(tmp_path):
    """Train 6 steps straight vs 3 + checkpoint/restore + 3: identical."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.zoo import build_model, make_batch
    from repro_torch.optim import AdamW

    cfg = get_smoke_config("granite-8b")
    batches = [make_batch(cfg, torch.Generator().manual_seed(i), 2, 16)
               for i in range(6)]

    def fresh():
        model = build_model(cfg, "cpu", trainable=True)
        model.init_params(torch.Generator().manual_seed(0))
        opt = AdamW(learning_rate=1e-3, decayed=model.decayed())
        return (model, build_train_step(model, opt, None, microbatches=1),
                opt.init(dict(model.named_parameters())))

    m1, step1, s1 = fresh()
    for b in batches:
        step1(s1, b)

    m2, step2, s2 = fresh()
    for b in batches[:3]:
        step2(s2, b)
    path = save_checkpoint(str(tmp_path), 3, (m2.state_dict(), s2))
    m3, step3, s3 = fresh()
    _, (params, s3_loaded) = restore_checkpoint(path, (m3.state_dict(), s3))
    m3.load_state_dict(params)
    s3.update(s3_loaded)
    for b in batches[3:]:
        step3(s3, b)

    for (n, a), b in zip(m1.state_dict().items(), m3.state_dict().values()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=n)
    assert int(s1["step"]) == int(s3["step"]) == 6
