"""One training step on each of the four architectures added with the MoE,
encoder and VLM families (reduced configs), against the reference's
compiled ``make_train_step``: 8-bit QAT (the MoE experts fake-quantized
per call, the router dense as the layer reads it), AdamW on all four and
Adafactor on qwen3-moe, the batches from ``make_batch`` (``features`` for
the encoder, ``patches`` for the VLM). Parameters in the reference's tree
(the MoE experts stacked as ``(L, E, d, f)`` under ``periods/b0_moe``).

Tolerances, measured on these seeds and stated here once: the loss
(cross entropy plus 0.01 times the MoE load-balancing loss) within 1e-5
relative, the gradient norm within 1e-3; at least ``SAME`` of each
updated bf16 leaf equal to the reference's, and every value of every leaf
within one update of the other sign rounded to the leaf's dtype (as
``tests/test_torch_train.py`` holds the dense step: a gradient near zero
can take the other sign). The float32 leaves (norm scales, the router)
are held to that bound alone: a sign flip is one value in the 32 of a
reduced q_norm scale, and Adafactor's clipped update moves every value
of a leaf by the last places of its RMS. The optimizer state within 5%
relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (the reference's layers import through models)
from repro.configs import get_reduced as jget
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.launch import inputs as jinputs
from repro.launch.steps import init_opt_state as jinit_opt, make_train_step as jmake_step
from repro.models.transformer import init_params as jinit
from repro.optim import OptimConfig as JOptimConfig
from repro_torch.configs import get_reduced as tget
from repro_torch.core import tree as tr
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.launch import inputs
from repro_torch.launch.steps import init_opt_state, make_train_step
from repro_torch.optim import OptimConfig

from _torch_parity import j2t, t2n

SAME = 0.97


def _tree(node):
    if isinstance(node, dict):
        return {k: _tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree(v) for v in node]
    return j2t(np.asarray(node))


def _jflat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(leaf).astype(np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch, optimizer", [
    ("qwen3-moe-235b-a22b", "adamw"), ("qwen3-moe-235b-a22b", "adafactor"),
    ("llama4-scout-17b-a16e", "adamw"), ("hubert-xlarge", "adamw"), ("internvl2-2b", "adamw")])
def test_train_step_matches_reference(arch, optimizer):
    jc, tc = jget(arch), tget(arch)
    jp = jax.jit(lambda k: jinit(jc, k))(jax.random.PRNGKey(0))
    tp = _tree(jp)
    seq = 12 + jc.num_patches
    jb = jinputs.make_batch(jc, 2, seq, "train", np.random.default_rng(0))
    tb = inputs.make_batch(tc, 2, seq, "train", np.random.default_rng(0), device="cpu")
    kw = dict(peak_lr=1e-3, total_steps=10, kind=optimizer)
    jopt, topt = JOptimConfig(**kw), OptimConfig(**kw)
    jstep = jax.jit(jmake_step(jc, jopt, policy=JPolicy.uniform(8, 8)))
    tstep = make_train_step(tc, topt, policy=PrecisionPolicy.uniform(8, 8))
    js = jinit_opt(jc, jopt, jp)
    ts = init_opt_state(tc, topt, tp)
    jnew, js2, jm = jstep(jp, js, jb, jnp.int32(0))
    tnew, ts2, tm = tstep(tp, ts, tb, 0)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    new = _jflat(jnew)
    paths = [tr.path_key(p) for p, _ in tr.flatten_with_path(tnew)]
    assert paths == list(new)  # the same leaves in the same order
    if jc.family == "moe":
        assert new["periods/b0_moe/moe/gate"].shape == (
            jc.n_layers, jc.n_experts, jc.d_model, jc.moe_d_ff)
    lr0 = topt.peak_lr / topt.warmup_steps
    for key, t_new, t_old in zip(paths, tr.leaves(tnew), tr.leaves(tp)):
        assert t_new.dtype == t_old.dtype, key
        a, b = new[key], t2n(t_new)
        if t_old.dtype == torch.bfloat16:  # float32 leaves: the bound alone
            assert (a == b).mean() >= SAME, key
        bound = 2 * lr0 + 2.0 ** -6 * np.maximum(np.abs(a), np.abs(b))
        assert (np.abs(a - b) <= bound).all(), key
    state = _jflat(js2)
    for path, leaf in tr.flatten_with_path(ts2):
        key = tr.path_key(path)
        a, b = state[key], t2n(leaf)
        assert np.linalg.norm(a - b) <= 0.05 * max(np.linalg.norm(a), 1e-30), key
