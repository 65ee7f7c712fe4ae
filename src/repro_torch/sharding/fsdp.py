"""The train step on a ``(data, model)`` mesh: each rank holds its blocks
of the reference's parameter tree (``sharding/rules.tree_param_specs``)
and of the optimizer state (``optim.state_specs``), and the layers run on
them with explicit collectives (``sharding/collectives.py``). It gives
the step the reference's GSPMD program gives on the same mesh, up to the
order of its sums.

* ``data`` is data parallel plus FSDP: every leaf is gathered over the
  data column where it is used, layer by layer inside the layer's
  checkpoint (so the backward gathers again), and its gradient
  reduce-scattered back (a leaf the data axis does not shard: all-reduced).
  Each rank takes its rows of every microbatch.
* ``pod`` (a multi-pod mesh) is pure data parallel: the rows are split
  over ``(pod, data)``, the loss reduced over both, and the step
  all-reduces every gradient over the pod axis (``launch/steps.py``).
* ``model`` is tensor parallel, Megatron's split: a block's input enters
  the region (identity forward, all-reduce backward); q/k/v and gate/up
  run on their column blocks (the rank's heads, its ffn slice), o_proj
  and down_proj on their row blocks, whose partial outputs are summed
  over the row (all-reduce). Query heads shard where they divide the
  model axis; KV heads that do not are gathered and each rank takes the
  ones its query heads read (the Megatron GQA rule). Where the query heads
  do not divide, the query rows are sharded instead (context parallel, as
  ``attention.py:276-279`` of the reference) and the output rows gathered.
  The embedding and the LM head are vocab parallel where the padded
  vocab divides (a masked lookup summed over the row; a cross entropy
  whose max, partition sum and gold logit are reduced over the row).
  The MoE experts are expert parallel (``layers/moe.moe_apply_gshard``
  with the mesh). The SSM and RG-LRU mixers, whose weights the rules
  shard on dims that are not heads, gather their weights and run whole on
  every rank of the row. The residual stream between blocks is
  replicated over the row (no sequence parallelism).
* Under QAT a row-parallel projection's per-channel and per-token amax
  are maxima over the row (``linear_apply``'s ``amax_reduce``).

Inside a region whose gradients are partial sums over the row (between
an ``enter`` and a ``reduce``) a weight gathered over ``model`` sums its
gradient back (reduce-scatter); outside one (replicated work) each rank
takes its block of the gradient every rank computed alike.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.core import tree as tr
from repro_torch.layers.attention import attention_apply
from repro_torch.layers.linear import linear_apply
from repro_torch.layers.mlp import mlp_apply
from repro_torch.sharding import collectives as col
from repro_torch.sharding.rules import P

def batch_axes(mesh) -> tuple:
    """The mesh's batch axes: ``pod`` and ``data``, those it has."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _dim_of(spec, axis: str) -> Optional[int]:
    for i, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return i
    return None


@dataclasses.dataclass
class ShardedTrain:
    """One rank's view of a sharded train step: the mesh and the specs of
    the parameter tree (the reference's layout)."""

    mesh: object
    specs: object

    @property
    def msize(self) -> int:
        return self.mesh.shape.get("model", 1)

    @property
    def data_group(self):
        return self.mesh.group("data")

    @property
    def batch_group(self):
        """The group over the batch axes (``pod`` and ``data``)."""
        return self.mesh.group(batch_axes(self.mesh))

    @property
    def model_group(self):
        return self.mesh.group("model")

    @property
    def model_rank(self) -> int:
        return self.mesh.coord("model") if "model" in self.mesh.axis_names else 0

    def layer_specs(self, cfg) -> dict:
        """The specs in the port's layer-list layout (:func:`unstack_specs`)."""
        return unstack_specs(cfg, self.specs)

    # -- leaves -------------------------------------------------------------

    def data_in(self, t: torch.Tensor, spec) -> torch.Tensor:
        """``t`` gathered over the data axis (FSDP; reduce-scatter
        backward), or, where the data axis does not shard it, as it is
        with its gradient summed over the data axis."""
        d = _dim_of(spec, "data")
        if d is None:
            return col.enter(t, self.data_group)
        return col.all_gather(t, d, self.data_group)

    def full(self, t: torch.Tensor, spec, *, partial: bool) -> torch.Tensor:
        """The whole leaf on every rank. ``partial``: it is used in a
        region whose gradients are partial sums over the model row."""
        t = self.data_in(t, spec)
        m = _dim_of(spec, "model")
        if m is not None:
            return col.all_gather(t, m, self.model_group, bwd="sum" if partial else "slice")
        return col.enter(t, self.model_group) if partial else t

    def model_sharded(self, spec, dim: int) -> bool:
        return self.msize > 1 and _dim_of(spec, "model") == dim % len(spec)

    # -- activations -----------------------------------------------------------

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return col.enter(x, self.model_group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return col.reduce(x, self.model_group)

    def amax_over_row(self, t: torch.Tensor) -> torch.Tensor:
        """The element-wise maximum over the model row (an amax of a
        row-parallel operand; exact)."""
        return col.all_reduce_(t, self.model_group, dist.ReduceOp.MAX)

    # -- layers -------------------------------------------------------------------

    def whole(self, p, spec):
        """A norm's or a mixer's parameters whole on every rank
        (replicated work)."""
        return tr.tree_map(lambda t, s: self.full(t, s, partial=False), p, spec)

    def attention(self, p, spec, h, positions, *, cfg, window, policy, training, backend,
                  name):
        """The attention sub-block's output, replicated over the row."""
        m = self.msize
        nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(head_dim=hd, causal=cfg.causal, window=window, rope_theta=cfg.rope_theta,
                  qk_norm=cfg.qk_norm, chunk=cfg.attn_chunk, policy=policy,
                  training=training, backend=backend, name=name)
        if m > 1 and nh % m == 0 and nh >= m:
            return self._head_parallel(p, spec, h, positions, nh, nkv, hd, kw)
        s = h.shape[1]
        if m > 1 and not window and s % m == 0:
            lp = tr.tree_map(lambda t, sp: self.full(t, sp, partial=True), p, spec)
            lo = self.model_rank * (s // m)
            out, _ = attention_apply(lp, self.enter(h), positions, n_heads=nh, n_kv_heads=nkv,
                                     q_rows=(lo, lo + s // m), **kw)
            return col.all_gather(out, 1, self.model_group, bwd="slice")
        lp = tr.tree_map(lambda t, sp: self.full(t, sp, partial=False), p, spec)
        out, _ = attention_apply(lp, h, positions, n_heads=nh, n_kv_heads=nkv, **kw)
        return out

    def _head_parallel(self, p, spec, h, positions, nh, nkv, hd, kw):
        m, r = self.msize, self.model_rank
        hl = nh // m
        lp = {
            "q_proj": {"w": self.data_in(p["q_proj"]["w"], spec["q_proj"]["w"])},
            "o_proj": {"w": self.data_in(p["o_proj"]["w"], spec["o_proj"]["w"]),
                       "amax_reduce": self.amax_over_row},
        }
        if nkv % m == 0:
            kvl = nkv // m
            for k in ("k_proj", "v_proj"):
                lp[k] = {"w": self.data_in(p[k]["w"], spec[k]["w"])}
        else:
            # each rank computes the KV heads its query heads read, one
            # per query head (the Megatron GQA rule)
            kvl = hl
            heads = torch.arange(r * hl, (r + 1) * hl) // (nh // nkv)
            cols = (heads[:, None] * hd + torch.arange(hd)[None, :]).reshape(-1)
            for k in ("k_proj", "v_proj"):
                w = self.full(p[k]["w"], spec[k]["w"], partial=True)
                lp[k] = {"w": w.index_select(1, cols.to(w.device))}
        for k in ("q_norm", "k_norm"):
            if k in p:
                lp[k] = tr.tree_map(lambda t, sp: self.full(t, sp, partial=True), p[k],
                                    spec[k])
        out, _ = attention_apply(lp, self.enter(h), positions, n_heads=hl, n_kv_heads=kvl,
                                 **kw)
        return self.reduce(out)

    def mlp(self, p, spec, h, *, act, policy, training, backend, name):
        """The MLP's output, replicated over the row: column-parallel
        gate/up and row-parallel down where the ffn dim is sharded."""
        if all(self.model_sharded(spec[k]["w"], -1) for k in p if k != "down_proj") \
                and self.model_sharded(spec["down_proj"]["w"], 0):
            lp = {k: {"w": self.data_in(p[k]["w"], spec[k]["w"])} for k in p}
            lp["down_proj"]["amax_reduce"] = self.amax_over_row
            out = mlp_apply(lp, self.enter(h), act=act, policy=policy, training=training,
                            backend=backend, name=name)
            return self.reduce(out)
        lp = tr.tree_map(lambda t, sp: self.full(t, sp, partial=False), p, spec)
        return mlp_apply(lp, h, act=act, policy=policy, training=training, backend=backend,
                         name=name)

    def vocab_block(self, spec) -> Optional[int]:
        """The dim the model axis shards a vocab leaf on, or None."""
        return _dim_of(spec, "model") if self.msize > 1 else None

    def embed(self, p, spec, tokens: torch.Tensor) -> torch.Tensor:
        """The token embedding: a masked lookup of the rank's vocab rows
        summed over the row where the vocab is sharded."""
        table = self.data_in(p["embedding"], spec["embedding"])
        if self.vocab_block(spec["embedding"]) != 0:
            return table[tokens]
        n = table.shape[0]
        local = tokens.to(torch.int64) - self.model_rank * n
        inside = (local >= 0) & (local < n)
        rows = table[torch.clamp(local, 0, n - 1)]
        rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
        return self.reduce(rows)

    def head(self, params, specs, x, *, cfg, policy, training, backend):
        """(logits, vocab offset): the rank's vocab block of the logits and
        its first column, or the whole logits and None."""
        if cfg.tie_embeddings:
            emb, sp = params["embed"]["embedding"], specs["embed"]["embedding"]
            table = self.data_in(emb, sp)
            with record_function("family.tied_head"):
                if self.vocab_block(sp) == 0:
                    logits = self.enter(x).to(torch.float32) @ table.to(torch.float32).T
                    return logits, self.model_rank * table.shape[0]
                return x.to(torch.float32) @ table.to(torch.float32).T, None
        w, sp = params["lm_head"]["head"]["w"], specs["lm_head"]["head"]["w"]
        if self.vocab_block(sp) == 1:
            wl = self.data_in(w, sp)
            logits = linear_apply({"w": wl}, self.enter(x), name="lm_head", policy=policy,
                                  training=training, backend=backend)
            return logits, self.model_rank * wl.shape[1]
        wf = self.full(w, sp, partial=False)
        return linear_apply({"w": wf}, x, name="lm_head", policy=policy, training=training,
                            backend=backend), None

    def cross_entropy(self, logits, targets, mask, n_valid, vocab_lo):
        """(this rank's term of the global mean token cross entropy, the
        global value, detached): the reference's stable form, with the max,
        the partition sum and the gold logit reduced over the row when the
        logits are a vocab block. The terms of the data ranks sum to the
        loss (and their gradients to its gradient)."""
        logits = logits.to(torch.float32)
        vl = logits.shape[-1]
        lo = 0 if vocab_lo is None else vocab_lo
        col_ids = lo + torch.arange(vl, device=logits.device)
        if n_valid is not None and (vocab_lo is not None or n_valid != vl):
            logits = torch.where(col_ids < n_valid, logits, torch.full_like(logits, -1e30))
        m = logits.detach().amax(dim=-1, keepdim=True)
        if vocab_lo is not None:
            m = self.amax_over_row(m.clone())
        sumexp = torch.sum(torch.exp(logits - m), dim=-1)
        local_t = targets.to(torch.int64) - lo
        inside = (local_t >= 0) & (local_t < vl)
        gold = torch.gather(logits, -1, torch.clamp(local_t, 0, vl - 1)[..., None])[..., 0]
        if vocab_lo is not None:
            sumexp = self.reduce(sumexp)
            gold = self.reduce(torch.where(inside, gold, torch.zeros_like(gold)))
        nll = m[..., 0] + torch.log(sumexp) - gold
        if mask is None:
            num, den = torch.sum(nll), float(nll.numel())
            den = torch.tensor(den, dtype=torch.float32, device=nll.device)
        else:
            mask = mask.to(torch.float32)
            num, den = torch.sum(nll * mask), torch.sum(mask).detach()
        den = col.all_reduce_(den.clone(), self.batch_group)
        term = num / torch.clamp_min(den, 1.0)
        value = col.all_reduce_(term.detach().clone(), self.batch_group)
        return term, value


def unstack_specs(cfg, specs) -> dict:
    """The spec tree in the port's layer-list layout (the counterpart of
    ``models.transformer.unstack_layers``): a stacked leaf's spec loses its
    leading (layer) entry."""
    if "layers" in specs:
        return specs
    period, n_full = cfg.period_layout()
    drop = lambda sp: P(*list(sp)[1:])
    per = [tr.tree_map(drop, specs["periods"][f"b{j}_{kind}"])
           for j, kind in enumerate(period)] if n_full else []
    layers = [per[j] for _ in range(n_full) for j in range(len(period))]
    layers += list(specs.get("tail", []))
    return {("layers" if k == "periods" else k): (layers if k == "periods" else v)
            for k, v in specs.items() if k != "tail"}
