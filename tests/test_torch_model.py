"""Port parity of the model pieces: parameter transfer and init, the KV
cache, and the package boundary (the quantized weight tree and the
forward's logits are held in test_torch_serving.py, beside the engines
that share the reference's compiles)."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (the reference's layers import through models)
from repro.configs import get_reduced as jget
from repro.models.cache import quantize_kv as jquantize_kv
from repro.models.transformer import init_params as jinit
from repro_torch.configs import get_reduced as tget
from repro_torch.models.cache import init_cache, insert_slot, quantize_kv, quantize_scratch
from repro_torch.models.transformer import init_params as tinit
from repro_torch.models.transformer import params_from_numpy

from _torch_parity import j2t, t2n, to_numpy_tree

ROOT = Path(__file__).resolve().parents[1]
_PARAMS: dict = {}


def _params(arch):
    """(JAX params, port params) from one JAX init, shared per module (the
    init runs compiled: eager JAX compiles every primitive on its own)."""
    if arch not in _PARAMS:
        jp = jax.jit(lambda k: jinit(jget(arch), k))(jax.random.PRNGKey(0))
        _PARAMS[arch] = (jp, params_from_numpy(tget(arch), to_numpy_tree(jp), device="cpu"))
    return _PARAMS[arch]


def test_params_from_numpy_unstacks_the_scanned_layers():
    jp, tp = _params("granite-3-8b")
    cfg = tget("granite-3-8b")
    assert len(tp["layers"]) == cfg.n_layers
    for i in range(cfg.n_layers):
        a = jp["periods"]["b0_dense"]["attn"]["q_proj"]["w"][i]
        b = tp["layers"][i]["attn"]["q_proj"]["w"]
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(np.asarray(a).astype(np.float32), t2n(b))
    np.testing.assert_array_equal(np.asarray(jp["lm_head"]["head"]["w"]).astype(np.float32),
                                  t2n(tp["lm_head"]["head"]["w"]))
    assert tp["embed"]["embedding"].shape == (cfg.vocab_padded, cfg.d_model)


def test_kv_quantize_equals_compiled_reference(rng):
    """KV is quantized inside the reference's compiled steps only."""
    x = (rng.standard_normal((3, 9, 2, 16)) * 2).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    qj, sj = jax.jit(jquantize_kv)(xj)
    qt, st = quantize_kv(j2t(xj))
    np.testing.assert_array_equal(np.asarray(qj), t2n(qt))
    np.testing.assert_array_equal(np.asarray(sj), t2n(st))


def test_insert_slot_overwrites_the_whole_extent():
    cfg = tget("granite-3-8b")
    cache = init_cache(cfg, 3, 12, kv_quant=True)
    for blk in cache["layers"]:
        for leaf in blk.values():
            leaf.fill_(7)
    seq = quantize_scratch(init_cache(cfg, 1, 12, kv_quant=False))
    insert_slot(cache, seq, 1)
    for blk, sblk in zip(cache["layers"], seq["layers"]):
        for key, leaf in blk.items():
            assert torch.equal(leaf[1], sblk[key][0].to(leaf.dtype)), key
            assert (leaf[0] == 7).all() and (leaf[2] == 7).all(), key
    with pytest.raises(ValueError, match="max_len"):
        insert_slot(cache, quantize_scratch(init_cache(cfg, 1, 8, kv_quant=False)), 0)


def test_init_params_mirrors_reference_distributions():
    cfg = tget("granite-3-8b")
    g = torch.Generator()
    g.manual_seed(0)
    tp = tinit(cfg, g)
    jp = _params("granite-3-8b")[0]
    w = tp["layers"][0]["mlp"]["down_proj"]["w"].float()
    assert w.dtype == torch.float32 and tp["layers"][0]["mlp"]["down_proj"]["w"].dtype == torch.bfloat16
    assert abs(float(w.std()) - cfg.d_ff**-0.5) < 0.1 * cfg.d_ff**-0.5
    jw = np.asarray(jp["periods"]["b0_dense"]["mlp"]["down_proj"]["w"][0]).astype(np.float32)
    assert abs(float(w.std()) - float(jw.std())) < 0.1 * float(jw.std())
    emb = tp["embed"]["embedding"].float()
    assert abs(float(emb.std()) - cfg.d_model**-0.5) < 0.1 * cfg.d_model**-0.5
    assert torch.equal(tp["final_norm"]["scale"], torch.ones(cfg.d_model))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax", "ml_dtypes"), (path, mod)
