"""The ranks of LM serving on a device mesh, one process each.

The LM's counterpart of ``ps/spmd_worker.py``: rank 0 is the process that
serves (``launch.serve --mesh host``, or a caller of ``LMMeshRun``); ranks
1..W-1 are fresh interpreters (``python -m repro_torch.serve.mesh_worker
<run_dir> <rank> <parent pid>``) that follow rank 0 through the same
command loop, with the same discipline: a log file each, a ``FileStore``
in the run's temporary directory, bounded waits, and ``close`` tearing
everything down.

Each step of the loop is a *call*: rank 0 broadcasts a method name and
its arguments on the mesh's gloo control group, and every rank runs
``LMRankProgram.op_<name>`` with them; what rank 0's returns is the
call's result.  The model's collectives add their host milliseconds,
bytes and counts to ``Mesh.stats``/``bytes``/``calls`` under their tags
(``embed``, ``attn``, ``mlp``, ``logits``, ``moe_push``, ``moe_pull``,
``moe_gather``, ...), which ``op_stats`` reports per rank.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Optional

import torch

from repro_torch.launch.mesh import WORLD, Mesh, ctx_for
from repro_torch.ps.spmd_worker import OP_FINISH, SpmdRun, run_helper

OP_CALL = 1


class LMRankProgram:
    """One rank's part of LM serving on a mesh.  ``spec`` holds the mesh
    shape (``data``, ``model``); the model arrives with ``op_load``."""

    def __init__(self, mesh: Mesh, spec: dict):
        self.mesh = mesh
        self.spec = spec
        self.ctx = ctx_for(mesh)
        self.dev = mesh.device
        self.model = None
        self.engine = None
        self.pending = None              # rank 0: the next call
        self.steps = 0

    def setup(self, init=None) -> None:
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)

    def step(self, op: int, arg: int = 0):
        if op == OP_FINISH:
            return None
        if op != OP_CALL:
            raise ValueError(f"unknown LM mesh op {op}")
        name, args, kwargs = self.mesh.broadcast_object(
            self.pending if self.mesh.rank == 0 else None)
        self.pending = None
        self.steps += 1
        return getattr(self, "op_" + name)(*args, **kwargs)

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # -- the model -----------------------------------------------------------
    def op_load(self, cfg, seed: int = 0, params: Optional[dict] = None,
                layout_shards: int = 1, capacity_factor=None,
                max_seq: int = 0, temperature: float = 0.0) -> dict:
        """Build this rank's blocks: drawn from ``seed``
        (``transformer.init_params``), or carried from a JAX pytree
        (``convert.lm_shard_from_arrays``).  Returns rank 0's view:
        seconds, bytes of its parameters."""
        from repro_torch import convert
        from repro_torch.models import transformer as tfm
        from repro_torch.serve.engine import Engine, ServeConfig

        self.op_release()
        self._sync()
        t0 = time.perf_counter()
        if params is None:
            model = tfm.init_params(seed, cfg, self.ctx, self.dev)
        else:
            model = convert.lm_shard_from_arrays(
                params, cfg, self.ctx, self.mesh.rank, self.dev,
                layout_shards)
        if capacity_factor is not None:
            model.set_capacity_factor(capacity_factor)
        self.model = model
        self.engine = Engine(model, ServeConfig(max_seq=max_seq or 1,
                                                temperature=temperature,
                                                seed=seed))
        self._sync()
        return {"load_s": time.perf_counter() - t0,
                "param_bytes": sum(p.numel() * p.element_size()
                                   for p in model.parameters())}

    def op_release(self) -> None:
        self.model = self.engine = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def op_set(self, capacity_factor: float) -> None:
        self.model.set_capacity_factor(capacity_factor)

    # -- serving -------------------------------------------------------------
    def op_generate(self, prompts: torch.Tensor, num_tokens: int,
                    cond: Optional[torch.Tensor] = None,
                    timed: bool = False):
        """``Engine.generate`` on every rank: the whole batch in, the whole
        batch's tokens out, on the CPU.  ``timed``: a dict instead, with
        the tokens, the prefill's ms (with its token), each decode step's
        ms (with its token), each part's collectives (this rank's ms,
        bytes and counts by tag) and each MoE layer's (dropped, routed)
        pairs of the prefill over every rank -- rank 0's is returned."""
        eng, mesh = self.engine, self.mesh
        eng.scfg.max_seq = max(eng.scfg.max_seq,
                               prompts.shape[1] + num_tokens)
        p = prompts.to(self.dev)
        c = None if cond is None else cond.to(self.dev)
        if not timed:
            return eng.generate(p, num_tokens, c).cpu()
        rec = {"step_ms": [], "decode_collectives": {}}

        def mark(part: str) -> None:
            self._sync()
            ms = (time.perf_counter() - rec.pop("t0")) * 1e3
            if part == "prefill":
                rec.update(prefill_ms=ms, prefill_collectives=_coll(mesh),
                           prefill_drops=self._drops())
                mesh.reset_stats()
            else:
                rec["step_ms"].append(ms)
                rec["decode_collectives"] = _coll(mesh)
            rec["t0"] = time.perf_counter()

        self._sync()
        mesh.reset_stats()
        self.model.moe_drops(reset=True)
        rec["t0"] = time.perf_counter()
        out = eng.generate(p, num_tokens, c, mark=mark)
        del rec["t0"]
        return dict(rec, tokens=out.cpu())

    def _drops(self) -> Optional[list]:
        """Each MoE layer's (dropped, routed) pairs since the last reset,
        summed over every rank (rank 0's view)."""
        per_rank = self.mesh.gather_object([list(d) for d in
                                            self.model.moe_drops()])
        return None if per_rank is None else [
            [sum(r[i][0] for r in per_rank), sum(r[i][1] for r in per_rank)]
            for i in range(len(per_rank[0]))]

    def op_generate_ranks(self, prompts: torch.Tensor, num_tokens: int,
                          cond: Optional[torch.Tensor] = None
                          ) -> Optional[list]:
        """``op_generate`` on every rank; rank 0 gets every rank's tokens,
        in rank order."""
        return self.mesh.gather_object(self.op_generate(prompts, num_tokens,
                                                        cond))

    def op_logits(self, tokens: torch.Tensor, steps: int,
                  cond: Optional[torch.Tensor] = None,
                  all_positions: bool = True, max_seq: int = 0,
                  per_rank: bool = False) -> dict:
        """Teacher-forced logits of the whole batch: the prompt
        ``tokens[:, :S - steps]`` through the full-sequence forward (every
        position's logits, or the last one's), then ``steps`` decode steps
        fed ``tokens[:, S - steps + i]``, in a cache of ``max_seq`` slots
        (default S; sequence-sharded where the batch is smaller than the
        data axis).  Physical rows of the mesh's vocab layout, float32, on
        the CPU (rank 0's result; ``per_rank``: also every data rank's own,
        ``rank_logits``)."""
        from repro_torch.models import transformer as tfm
        from repro_torch.models.layers import gather_vocab

        model, mesh, eng = self.model, self.mesh, self.engine
        b = tokens.shape[0]
        rows = eng.local_batch(b)
        tok = tokens[rows].to(self.dev)
        c = None if cond is None else cond[rows].to(self.dev)
        sp = tok.shape[1] - steps
        caches = tfm.allocate_cache(model.cfg, tok.shape[0],
                                    max_seq or tok.shape[1], self.dev,
                                    self.ctx, eng.seq_sharded(b))
        head_at = None if all_positions else slice(-1, None)
        model.moe_drops(reset=True)
        with torch.no_grad():
            full, _ = model(tok[:, :sp], c, caches=caches, head_at=head_at,
                            remat=False)
            outs = [gather_vocab(full, self.ctx).float()]
            for i in range(steps):
                lg = model.decode_step(tok[:, sp + i], caches, sp + i, c)
                outs.append(gather_vocab(lg, self.ctx).float()[:, None])
        out = torch.cat(outs, dim=1)
        ranks = mesh.gather_object(out.cpu()) if per_rank else None
        if out.shape[0] < b:             # this rank's data slice
            out = mesh.all_gather(out, "data", tag="logits")
        return {"logits": out.cpu(), "rank_logits": ranks,
                "drops": self._drops()}

    # -- the MoE check ---------------------------------------------------------
    def op_moe_check(self, shape, seed: int) -> Optional[dict]:
        """The first MoE layer on a seeded input ``shape`` ([B, S, D], the
        whole batch, in the model's dtype; each rank takes its data
        slice): its output on every rank, gathered to rank 0, against
        ``moe_block_spmd_emulated`` of the layer's logical weights on the
        same input (on rank 0): the routed part (``routed_equal``: the
        same operations on the same blocks, so bitwise) and the whole
        output (the shared experts: tensor-parallel here, whole there).
        Returns rank 0's comparison."""
        from repro_torch.models import moe as moe_mod
        from repro_torch.models import transformer as tfm
        from repro_torch.sharding.specs import SINGLE

        model, mesh, cfg = self.model, self.mesh, self.model.cfg
        name, blk = next((f"{st}.{i}", b) for st, i, b, _, _ in
                         model.schedule() if hasattr(b, "moe"))
        moe = blk.moe
        g = torch.Generator(device=self.dev).manual_seed(seed)
        x = torch.randn(shape, generator=g, device=self.dev,
                        dtype=torch.float32).to(tfm.dtype_of(cfg))
        rows = self.engine.local_batch(shape[0])
        xl = x[rows]
        moe.drops = (0, 0)
        self._sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            y, aux = moe_mod.moe_block(moe, xl, cfg, self.ctx)
        self._sync()
        ms = (time.perf_counter() - t0) * 1e3
        drops = moe.drops

        def whole(t):
            t = t.reshape(-1, t.shape[-1])
            return mesh.all_gather(t, "data", tag="check") \
                if mesh.data > 1 else t

        y_all, routed = whole(y), whole(moe.last_routed)
        # every rank's blocks of the layer's weights -> logical, on rank 0
        local = {n: p.detach() for n, p in moe.named_parameters()}
        gathered = {n: mesh.all_gather(t.unsqueeze(0), WORLD, tag="check")
                    for n, t in local.items()}
        dropped = mesh.all_reduce(torch.tensor(drops, dtype=torch.float64),
                                  WORLD, tag="check")
        if mesh.rank != 0:
            return None
        ref = moe_mod.MoE(cfg, self.dev, ctx=SINGLE)
        prefix = f"{name}.moe."
        with torch.no_grad():
            for n, p in ref.named_parameters():
                blocks = list(gathered[n].unbind(0))
                p.copy_(tfm.unshard_leaf(prefix + n, blocks, cfg, self.ctx))
        ref.capacity_factor = moe.capacity_factor
        del gathered
        with torch.no_grad():
            emu = moe_mod.moe_block_spmd_emulated(
                ref, x, cfg, mesh.data, mesh.model)
        want = emu.y.reshape(-1, x.shape[-1]).float()
        got = y_all.float()
        scale = want.abs().amax(-1, keepdim=True).clamp(min=1e-30)
        routed_want = torch.cat(emu.routed)[:routed.shape[0]]
        rscale = routed_want.float().abs().amax(-1, keepdim=True).clamp(
            min=1e-30)
        return {"layer": name, "shape": list(shape),
                "capacity_factor": moe.capacity_factor,
                "routed_equal": bool(torch.equal(routed, routed_want)),
                "routed_max_rel_err": float(
                    ((routed.float() - routed_want.float()).abs()
                     / rscale).max()),
                "max_rel_err": float(((got - want).abs() / scale).max()),
                "aux": float(aux), "aux_emulated": float(emu.aux),
                "dropped": int(dropped[0]), "pairs": int(dropped[1]),
                "dropped_emulated": emu.dropped, "pairs_emulated": emu.pairs,
                "ms": ms}

    # -- statistics ------------------------------------------------------------
    def op_stats(self) -> Optional[list]:
        """Every rank's peak device memory, model bytes and collectives
        (rank 0 gets the list)."""
        on_card = self.dev.type == "cuda"
        me = {"rank": self.mesh.rank, "data_idx": self.mesh.data_idx,
              "model_idx": self.mesh.model_idx, "pid": os.getpid(),
              "max_memory_allocated": (torch.cuda.max_memory_allocated(
                  self.dev) if on_card else None),
              "param_bytes": (sum(p.numel() * p.element_size()
                                  for p in self.model.parameters())
                              if self.model is not None else 0),
              "collectives": _coll(self.mesh)}
        return self.mesh.gather_object(me)

    def op_reset_peak(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)


def _coll(mesh: Mesh) -> dict:
    return {tag: {"ms": mesh.stats.get(tag, 0.0),
                  "bytes": mesh.bytes.get(tag, 0),
                  "calls": mesh.calls.get(tag, 0)}
            for tag in sorted(set(mesh.stats) | set(mesh.bytes))}


class LMMeshRun(SpmdRun):
    """Rank 0's side of LM serving on a ``data x model`` mesh: starts the
    helpers, joins the mesh, and runs calls on every rank
    (``call(name, *args)``: ``LMRankProgram.op_<name>``).  ``spec`` needs
    ``data`` and ``model``; ``device`` is rank 0's (the transport follows
    from it and the rank count, ``launch.mesh.transport_for``)."""

    worker_module = "repro_torch.serve.mesh_worker"
    build_kernels = False        # the LM path launches no hand kernel

    @staticmethod
    def make_program(mesh: Mesh, spec: dict):
        return LMRankProgram(mesh, spec)

    def call(self, name: str, *args, **kwargs):
        self.program.pending = (name, args, kwargs)
        try:
            return self.do(OP_CALL)
        except RuntimeError:
            # a helper that failed takes the collective down with it:
            # raise with its log, once it has exited
            deadline = time.time() + 30.0
            while time.time() < deadline and all(
                    p.poll() is None for p in self.procs):
                time.sleep(0.1)
            self.check_alive()
            raise

    def finish(self) -> None:
        if not self.finished:
            self.do(OP_FINISH)

    def __enter__(self) -> "LMMeshRun":
        return self.start()

    def __exit__(self, *exc) -> None:
        try:
            if exc[0] is None:
                self.finish()
        finally:
            self.close()


def main(argv=None) -> int:
    """A helper rank: ``python -m repro_torch.serve.mesh_worker <run_dir>
    <rank> <parent pid>``."""
    return run_helper(argv, LMRankProgram)


if __name__ == "__main__":
    sys.exit(main())
