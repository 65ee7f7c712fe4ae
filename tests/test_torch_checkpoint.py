"""The port's checkpoint manager against the reference's: the same npz +
meta.json layout, keys, dtype names and crc32 checksums, so a checkpoint
written by either package restores in the other bit for bit (bf16
through its uint16 view); corruption detection, GC, async saves; and a
trainer resuming from the other package's checkpoint."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (the reference's layers import through models)
from repro.checkpoint import CheckpointManager as JManager
from repro.configs import get_reduced as jget
from repro.launch.train import TrainRun as JTrainRun
from repro_torch.checkpoint import CheckpointCorruptionError, CheckpointManager
from repro_torch.configs import get_reduced as tget
from repro_torch.launch.train import TrainRun

from _torch_parity import j2t, t2n


def _jstate(seed=0):
    """A reference-shaped state: nested dicts, a list, bf16 / f32 / int32 /
    int8 leaves, a 0-d leaf and an empty one."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16),
                   "b": jnp.asarray(rng.standard_normal(3), jnp.float32),
                   "layers": [{"s": jnp.asarray(rng.standard_normal((2, 5)), jnp.bfloat16)},
                              {"s": jnp.asarray(rng.standard_normal((2, 5)), jnp.bfloat16)}]},
        "opt": {"m": jnp.asarray(rng.standard_normal((4, 6)), jnp.float32),
                "count": jnp.asarray(7, jnp.int32), "empty": jnp.zeros((0, 3), jnp.float32)},
        "q": jnp.asarray(rng.integers(-128, 128, 9), jnp.int8),
    }


def _ttree(tree):
    if isinstance(tree, dict):
        return {k: _ttree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_ttree(v) for v in tree]
    return j2t(np.asarray(tree))


def _assert_same(jtree, ttree):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    from repro_torch.core.tree import flatten_with_path, path_key
    tl = flatten_with_path(ttree)
    assert [path_key(p) for p, _ in tl] == [
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p) for p, _ in jl]
    for (_, a), (_, b) in zip(jl, tl):
        a = np.asarray(a)
        if a.dtype == jnp.bfloat16:
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(a.view(np.uint16), b.view(torch.int16).numpy().view(np.uint16))
        else:
            assert str(a.dtype) == str(b.numpy().dtype)
            np.testing.assert_array_equal(a, b.numpy())


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    js = _jstate()
    JManager(str(tmp_path), async_save=False).save(4, js, extra={"note": "ref"})
    state, meta = CheckpointManager(str(tmp_path)).restore(_ttree(_jstate(1)))
    assert meta["step"] == 4 and meta["note"] == "ref"
    _assert_same(js, state)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    js = _jstate()
    CheckpointManager(str(tmp_path), async_save=False).save(2, _ttree(js), extra={"note": "port"})
    state, meta = JManager(str(tmp_path)).restore(_jstate(1))
    assert meta["step"] == 2 and meta["note"] == "port"
    for a, b in zip(jax.tree_util.tree_leaves(js), jax.tree_util.tree_leaves(state)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                                      np.asarray(b).reshape(-1).view(np.uint8))


def test_same_layout_keys_dtypes_and_checksums(tmp_path):
    """Both packages write the same arrays, in the same order, with the
    same dtype names and crc32s."""
    js = _jstate()
    JManager(str(tmp_path / "j"), async_save=False).save(0, js)
    CheckpointManager(str(tmp_path / "t"), async_save=False).save(0, _ttree(js))
    metas, files = [], []
    for side in ("j", "t"):
        d = tmp_path / side / "step_0"
        meta = json.loads((d / "meta.json").read_text())
        metas.append((meta["_dtypes"], meta["_checksums"]))
        with np.load(d / "arrays.npz") as z:
            files.append([(k, z[k].dtype.str, z[k].tobytes()) for k in z.files])
    assert metas[0] == metas[1]
    assert files[0] == files[1]
    assert metas[0][0]["params/w"] == "bfloat16"


def test_flipped_byte_raises_corruption_error(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    state = _ttree(_jstate())
    mgr.save(1, state)
    path = tmp_path / "step_1" / "arrays.npz"
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["opt/m"].reshape(-1).view(np.uint8)[5] ^= 0x10  # one bit of one byte
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(CheckpointCorruptionError, match="opt/m"):
        mgr.restore(state)
    # the reference sees the same corruption in the port's checkpoint
    from repro.checkpoint import CheckpointCorruptionError as JCorruption
    with pytest.raises(JCorruption, match="opt/m"):
        JManager(str(tmp_path)).restore(_jstate())


def test_gc_keeps_three_and_async_saves(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    state = _ttree(_jstate())
    for step in range(6):
        mgr.save(step, state)
    mgr.wait()
    assert mgr.steps() == [3, 4, 5] and mgr.latest_step() == 5
    assert not list(tmp_path.glob("*.tmp"))
    assert [s["step"] for s in mgr.saves] == list(range(6))
    assert all(s["bytes"] > 0 for s in mgr.saves)
    restored, meta = mgr.restore(state, step=4)
    assert meta["step"] == 4
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore({"nope": torch.zeros(1)})
    with pytest.raises(ValueError, match="vs model"):
        mgr.restore(dict(state, q=torch.zeros(3, dtype=torch.int8)))


def _run(cls, cfg, **kw):
    base = dict(cfg=cfg, steps=6, global_batch=4, seq_len=32, peak_lr=1e-3, log_every=100)
    base.update(kw)
    return cls(**base)


def test_trainers_resume_from_each_others_checkpoints(tmp_path):
    """Both trainers hold the reference's tree. Each package trains 6
    steps saving at step 3 (and its final step 5, deleted: a crash after
    the step-3 save); the other package resumes at step 4. Its losses are
    the uninterrupted run's within 1e-3 (the train step's tolerance,
    test_torch_train.py)."""
    import shutil

    for first, second, fcfg, scfg, kw in (
            (JTrainRun, TrainRun, jget, tget, ({}, {"device": "cpu"})),
            (TrainRun, JTrainRun, tget, jget, ({"device": "cpu"}, {}))):
        ck = tmp_path / first.__module__.split(".")[0]
        straight = _run(first, fcfg("granite-3-8b"), ckpt_dir=str(ck), ckpt_every=4,
                        **kw[0]).run()["losses"]
        shutil.rmtree(ck / "step_5")
        resumed = _run(second, scfg("granite-3-8b"), ckpt_dir=str(ck), **kw[1]).run()["losses"]
        assert len(straight) == 6 and len(resumed) == 2
        np.testing.assert_allclose(resumed, straight[4:], rtol=1e-3)
