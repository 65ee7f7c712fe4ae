"""Dry run: every (architecture x input-shape) cell on the production
meshes, with a cost, memory and roofline report for the H100 (the port of
``src/repro/launch/dryrun.py``, the reference's capacity planner).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]

Each cell builds rank 0's step of the port at the full configuration on
the reference's 16 x 16 ``(data, model)`` mesh (2 x 16 x 16 with
``--multi-pod``) and runs it once on meta tensors under
``launch/cost.report``: nothing of the cell's size is allocated, and no
process group is needed (``launch/mesh.make_dry_mesh``: the collectives
record their calls and return outputs of the right shape).

* **train** cells run ``sharding/fsdp.ShardedTrain`` through
  ``make_train_step(mesh=, specs=)`` with the profile's optimizer,
  microbatches (clamped as the reference clamps them, so each
  microbatch's rows divide the batch shards) and gradient accumulation
  dtype, on the rank's parameter and optimizer blocks.
* **prefill** and **decode** cells run the port's tensor-parallel serving
  steps (``make_tp_prefill_step`` / ``make_tp_cb_decode_step``) with the
  profile's serving policy (digit-level Booth w8a8, the front end and the
  router dense), tensor parallel over ``model``; each data row takes its
  share of ``global_batch`` (a batch that does not divide is replicated,
  as the reference's). The heads follow ``sharding/tp.head_layout``. This
  layout is the port's, not the reference's GSPMD one; each record names
  it.

Each cell writes ``<out>/<arch>__<shape>__<mesh>.json``: ``status`` (OK,
SKIP with the reference's reason, or FAIL with its traceback), ``chips``,
``memory`` (rank 0's resident, input and peak bytes, the peak's largest
buffers, ``fits_80gb``), ``collectives`` by kind (count, operand bytes,
wire bytes) and ``roofline`` (``launch/roofline.Roofline.row()``). Every
time in a record is a prediction for the H100 SXM row at 700 W, not a
measurement. The CLI exits 1 if any cell fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback

import torch

from repro_torch.configs import ARCH_NAMES, SHAPES, cell_applicable, get_config
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.launch import cost, roofline
from repro_torch.launch.inputs import input_specs
from repro_torch.launch.mesh import make_dry_mesh, production_shape
from repro_torch.launch.steps import (
    init_opt_state,
    make_tp_cb_decode_step,
    make_tp_prefill_step,
    make_train_step,
)
from repro_torch.launch.train import init_blocks
from repro_torch.models.cache import init_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.quant import quantize_params
from repro_torch.models.transformer import init_params
from repro_torch.optim import OptimConfig
from repro_torch.sharding import rules as sh
from repro_torch.sharding.collectives import DryGroup
from repro_torch.sharding.fsdp import batch_axes
from repro_torch.sharding.tp import TPContext, head_layout

META = torch.device("meta")


@dataclasses.dataclass
class ArchProfile:
    """Per-arch dry-run settings (the reference's, memory-driven)."""

    optimizer: str = "adamw"
    microbatches: int = 1
    grad_accum_dtype: str = "float32"
    remat_group: int = 1
    # the paper's technique, as the reference serves it (digit-serial Booth w8a8)
    serve_policy: PrecisionPolicy = dataclasses.field(
        default_factory=lambda: PrecisionPolicy.uniform(
            8, 8, variant="booth", level="digit",
            keep_dense=("frontend", "router"),  # routing stays dense (tiny, accuracy-critical)
        )
    )
    # training is dense bf16, as the reference's profiles train
    train_policy: PrecisionPolicy = dataclasses.field(default_factory=PrecisionPolicy.off)


PROFILES = {
    "llama3-405b": ArchProfile(
        optimizer="adafactor", microbatches=16, grad_accum_dtype="bfloat16",
    ),
    "deepseek-coder-33b": ArchProfile(optimizer="adafactor", microbatches=2),
    "qwen3-moe-235b-a22b": ArchProfile(
        optimizer="adafactor", microbatches=16, grad_accum_dtype="bfloat16",
    ),
    "llama4-scout-17b-a16e": ArchProfile(optimizer="adafactor", microbatches=2),
    "mamba2-1.3b": ArchProfile(microbatches=2),
    "recurrentgemma-2b": ArchProfile(microbatches=4),
}


def profile_for(arch: str) -> ArchProfile:
    return PROFILES.get(arch, ArchProfile())


def _batch_shards(mesh) -> int:
    return max(mesh.extent(batch_axes(mesh)), 1)


def _train_cell(cfg: ModelConfig, shape, mesh, profile: ArchProfile):
    """Rank 0's sharded train step: (report, notes)."""
    mb = max(min(profile.microbatches, shape.global_batch // _batch_shards(mesh)), 1)
    opt_cfg = OptimConfig(kind=profile.optimizer)
    with sh.use_rules(sh.rules_for_mesh(mesh)):
        params, specs = init_blocks(cfg, torch.Generator(), META, mesh)
        opt_state = init_opt_state(cfg, opt_cfg, params)
        batch = input_specs(cfg, shape, meta=True)
        step = make_train_step(cfg, opt_cfg, policy=profile.train_policy, microbatches=mb,
                               mesh=mesh, specs=specs,
                               grad_accum_dtype=profile.grad_accum_dtype)
        with cost.report(resident={"params": params, "opt": opt_state}, inputs=batch) as rep:
            step(params, opt_state, batch, 0)
    notes = {"layout": "FSDP over data, tensor and expert parallel over model"
                       + (", data parallel over pod" if "pod" in mesh.axis_names else ""),
             "microbatches": mb, "optimizer": profile.optimizer,
             "grad_accum_dtype": profile.grad_accum_dtype}
    return rep, notes


def _local_params(cfg: ModelConfig, tp: TPContext) -> dict:
    """Rank 0's dense tree on meta tensors, in the shapes its shard tree
    has: its heads' q/k/v/o (or the whole attention where the heads do not
    divide), its ffn block of gate/up/down, its vocab block of the head;
    every other leaf whole (the embedding, norms, the front end, the MoE
    router and experts, the SSM and RG-LRU mixers)."""
    if cfg.d_ff % tp.size or cfg.vocab_padded % tp.size:
        raise ValueError(f"{cfg.name}: d_ff {cfg.d_ff} and the padded vocab "
                         f"{cfg.vocab_padded} must divide over {tp.size} ranks")
    local = dataclasses.replace(tp.local_config(cfg), d_ff=cfg.d_ff // tp.size)
    params = init_params(local, torch.Generator(), device=META)
    if "lm_head" in params:
        w = params["lm_head"]["head"]["w"]
        params["lm_head"]["head"]["w"] = w.new_empty((w.shape[0], w.shape[1] // tp.size))
    return params


def _serve_cell(cfg: ModelConfig, shape, mesh, profile: ArchProfile):
    """Rank 0's tensor-parallel prefill or decode step: (report, notes)."""
    msize = mesh.shape["model"]
    layout, replicated, _, _ = head_layout(cfg, msize)
    tp = TPContext(size=msize, rank=0, group=DryGroup(msize, 0), replicated=replicated)
    policy = profile.serve_policy
    shards = _batch_shards(mesh)
    rows = shape.global_batch // shards if shape.global_batch % shards == 0 \
        else shape.global_batch
    local = tp.local_config(cfg)
    q_params = quantize_params(_local_params(cfg, tp), policy, cfg=local, plane_cache=True)
    specs = input_specs(cfg, dataclasses.replace(shape, global_batch=rows), meta=True)
    if shape.kind == "prefill":
        step = make_tp_prefill_step(cfg, tp, policy, kv_quant=cfg.is_decoder)
        with cost.report(resident={"params": q_params}, inputs=specs) as rep:
            step(q_params, specs)
    else:
        cache = init_cache(local, rows, shape.seq_len, cfg.dtype, kv_quant=True, device=META)
        tokens = specs["tokens"]
        temps = torch.empty((rows,), dtype=torch.float32, device=META)
        step = make_tp_cb_decode_step(cfg, tp, policy)
        with cost.report(resident={"params": q_params, "cache": cache},
                         inputs=(tokens, temps)) as rep:
            step(q_params, cache, tokens, temps)
    notes = {"layout": f"tensor parallel over model ({layout}), "
                       f"{'rows split' if rows < shape.global_batch else 'rows replicated'} "
                       "over the batch axes",
             "rows_per_rank": rows, "policy": policy.describe()}
    return rep, notes


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: pathlib.Path) -> dict:
    """One cell's record (written to ``out_dir``)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_shape, axes = production_shape(multi_pod)
    mesh_name = "x".join(str(s) for s in mesh_shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        rec.update(status="SKIP", reason=why)
        _write(out_dir, rec)
        return rec
    mesh = make_dry_mesh(mesh_shape, axes)
    chips = mesh.size
    profile = profile_for(arch)
    if profile.remat_group > 1:
        cfg = dataclasses.replace(cfg, remat_group=profile.remat_group)
    t0 = time.time()
    try:
        cell = _train_cell if shape.kind == "train" else _serve_cell
        rep, notes = cell(cfg, shape, mesh, profile)
    except Exception as e:  # a failure here is a fault of the port
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        _write(out_dir, rec)
        return rec
    rl = rep.roofline(arch, shape_name, mesh_name, chips, roofline.model_flops(cfg, shape))
    rec.update(
        status="OK",
        step_s=round(time.time() - t0, 1),
        chips=chips,
        **notes,
        calls=dict(rep.calls),
        memory={
            "resident_bytes": rep.resident_bytes,
            "resident_by": rep.resident_by,
            "input_bytes": rep.input_bytes,
            "peak_bytes": rep.peak_bytes,
            "top": rep.top,
            "fits_80gb": bool(rep.peak_bytes < roofline.H100.hbm_bytes),
        },
        collectives={k: {"count": int(v["count"]), "bytes": int(v["bytes"]),
                         "wire": int(v["wire"])} for k, v in sorted(rep.collectives.items())},
        roofline=rl.row(),
    )
    _write(out_dir, rec)
    return rec


def _write(out_dir: pathlib.Path, rec: dict) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    (out_dir / name).write_text(json.dumps(rec, indent=1, default=str))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    archs = ARCH_NAMES if (args.all or not args.arch) else (args.arch,)
    shapes = tuple(SHAPES) if (args.all or not args.shape) else (args.shape,)
    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    t0 = time.time()
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, out_dir)
                status = rec["status"]
                if status == "OK":
                    r, m = rec["roofline"], rec["memory"]
                    extra = (f" compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
                             f"coll={r['collective_s']:.4f}s bottleneck={r['bottleneck']} "
                             f"peak={m['peak_bytes'] / 2**30:.2f}GiB fits={m['fits_80gb']} "
                             f"({rec['step_s']}s)")
                elif status == "FAIL":
                    extra = " " + rec["error"][:160]
                else:
                    extra = " " + rec["reason"]
                print(f"[{status}] {arch} x {shape} x {rec['mesh']}{extra}", flush=True)
                results.append(rec)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\n{len(results)} cells: {sum(r['status'] == 'OK' for r in results)} ok, "
          f"{sum(r['status'] == 'SKIP' for r in results)} skip, {n_fail} fail "
          f"in {time.time() - t0:.1f} s")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
