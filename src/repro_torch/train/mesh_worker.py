"""The ranks of LM training on a device mesh, one process each.

The training twin of ``serve/mesh_worker.py``, with the same discipline
(``ps/spmd_worker.SpmdRun``: a log file each, a ``FileStore`` in the run's
temporary directory, bounded waits, ``close`` tearing everything down):
rank 0 is the process that trains (``launch.train --mesh host``, or a
caller of ``LMTrainRun``), ranks 1..W-1 are fresh interpreters
(``python -m repro_torch.train.mesh_worker <run_dir> <rank> <parent
pid>``).  Each call broadcasts a method name and its arguments and every
rank runs ``LMTrainProgram.op_<name>``; rank 0's result is the call's.

Every rank holds its ``TrainState`` (``train.loop``: its parameter
blocks, its ZeRO moment blocks) and runs ``make_train_step`` on the same
global batches.  The logical state leaves the ranks through files: each
rank writes its blocks and their specs (``op_train_dump``), and
``convert.lm_arrays_from_dumps`` assembles the JAX pytree, one leaf at a
time.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Optional

import torch

from repro_torch.serve.mesh_worker import LMMeshRun, LMRankProgram
from repro_torch.ps.spmd_worker import run_helper


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _args(batch: dict, cfg) -> list:
    keys = ["tokens", "targets", "mask"] + (["cond"] if cfg.cross_attn_mode
                                            else [])
    return [batch[k] for k in keys]


class LMTrainProgram(LMRankProgram):
    """One rank's part of LM training on a mesh (and, inherited, of
    serving: ``op_stats``, ``op_reset_peak``)."""

    def __init__(self, mesh, spec: dict):
        super().__init__(mesh, spec)
        self.state = None
        self.tc = None
        self.step_fn = None
        self.grads = None

    def op_release(self) -> None:
        self.state = self.grads = self.step_fn = None
        super().op_release()

    def op_train_init(self, cfg, tc, seed: int = 0,
                      params: Optional[dict] = None, opt_state=None
                      ) -> dict:
        """Build this rank's ``TrainState``: drawn from ``seed``
        (``loop.init_state``: the rank's blocks of the single-device
        weights of that seed), or carried from a JAX ``params`` pytree
        and, when given, its ``opt_state`` (``convert``).  Returns rank
        0's seconds and bytes of parameters and moments."""
        from repro_torch import convert
        from repro_torch.train import loop

        self.op_release()
        self._sync()
        t0 = time.perf_counter()
        if params is None:
            state = loop.init_state(seed, cfg, self.ctx, self.dev)
        else:
            state = convert.train_state_from_arrays(
                params, opt_state, cfg, self.dev, self.ctx)
        self.state, self.model, self.tc = state, state.model, tc
        self.step_fn = loop.jit_train_step(cfg, tc, self.ctx, state)
        self._sync()
        moments = list(state.opt.m.values()) + list(state.opt.v.values())
        return {"load_s": time.perf_counter() - t0,
                "param_bytes": sum(p.numel() * p.element_size()
                                   for p in state.model.parameters()),
                "moment_bytes": sum(t.numel() * t.element_size()
                                    for t in moments)}

    def op_train_step(self, batch: dict) -> dict:
        """One ``make_train_step`` (``loop.step_grads`` then
        ``loop.apply_grads``) on the global ``batch`` (numpy arrays or
        tensors); its metrics as floats."""
        self.grads = None
        b = _to_device(batch, self.dev)
        self.state, met = self.step_fn(self.state, *_args(b, self.cfg))
        return {k: float(v) for k, v in met.items()}

    @property
    def cfg(self):
        return self.model.cfg

    def op_train_grads(self, batch: dict) -> dict:
        """A step's first half (``loop.step_grads``: each rank's ZeRO
        slices of the accumulated float32 gradient), kept for
        ``op_train_apply`` and ``op_train_dump``; its metrics as floats,
        and (rank 0) the (token, expert) pairs dropped and routed over
        every rank."""
        from repro_torch.train import loop
        b = _to_device(batch, self.dev)
        self.model.moe_drops(reset=True)
        self.grads, met = loop.step_grads(
            self.state, max(self.tc.microbatch, 1), *_args(b, self.cfg))
        drops = self.mesh.gather_object(self.model.moe_drops(reset=True))
        out = {k: float(v) for k, v in met.items()}
        if drops is not None:
            out["dropped"] = sum(d for rank in drops for d, _ in rank)
            out["pairs"] = sum(n for rank in drops for _, n in rank)
        return out

    def op_train_apply(self) -> dict:
        """The step's second half (``loop.apply_grads``) on the gradient
        of the last ``op_train_grads``, without running the batch again;
        its metrics (``lr``, ``grad_norm``) as floats."""
        from repro_torch.train import loop
        self.state, om = loop.apply_grads(self.state, self.grads, self.tc)
        return {k: float(v) for k, v in om.items()}

    def op_train_fit(self, batches, log_every: int = 1) -> dict:
        """``loop.fit`` over ``batches`` on every rank (rank 0 logs), the
        collective counters and the peak memory reset first.  Returns
        rank 0's history and every rank's: the parameter blocks and
        moment blocks that did not move, its collectives by tag (ms,
        bytes, calls) and its peak device memory."""
        from repro_torch.serve.mesh_worker import _coll
        from repro_torch.train import loop
        before = self._sums()
        log = print if self.mesh.rank == 0 else (lambda *a: None)
        self._sync()
        self.mesh.reset_stats()
        self.op_reset_peak()
        self.model.moe_drops(reset=True)
        self.state, history = loop.fit(self.state, batches, self.cfg,
                                       self.tc, self.ctx, log_every, log)
        self._sync()
        after = self._sums()
        opt = self.state.opt
        me = {"unmoved_params": [n for n in before
                                 if after[n] == before[n]],
              "unmoved_moments": [n for n in opt.m
                                  if not (float(opt.m[n].abs().max()) > 0
                                          and float(opt.v[n].max()) > 0)],
              "collectives": _coll(self.mesh),
              "max_memory_allocated": (
                  torch.cuda.max_memory_allocated(self.dev)
                  if self.dev.type == "cuda" else None),
              "drops": [list(d) for d in self.model.moe_drops(reset=True)]}
        return {"history": history, "ranks": self.mesh.gather_object(me)}

    def _sums(self) -> dict:
        return {n: float(torch.sum(p.detach(), dtype=torch.float64))
                for n, p in self.state.model.named_parameters()}

    def op_train_shapes(self) -> Optional[list]:
        """Every rank's parameter block and moment block shapes (rank 0
        gets the list)."""
        from repro_torch.train import loop
        specs = loop.state_specs(self.state, self.ctx)
        me = {n: {"param": tuple(p.shape),
                  "moment": tuple(self.state.opt.m[n].shape),
                  "spec": tuple(specs["opt"].m[n])}
              for n, p in self.state.model.named_parameters()}
        return self.mesh.gather_object(me)

    def op_train_dump(self, path: str, kinds=("params", "m", "v")) -> None:
        """Write this rank's blocks of each of ``kinds`` (``params``,
        ``m``, ``v``, ``grads``: the last ``op_train_grads``) and their
        specs to ``path/rank<r>.pt`` on the CPU."""
        from repro_torch.train import loop
        state = self.state
        specs = loop.state_specs(state, self.ctx)
        tensors = {"params": state.params, "m": state.opt.m,
                   "v": state.opt.v, "grads": self.grads}
        out = {"specs": {}}
        for kind in kinds:
            out[kind] = {n: t.detach().cpu() for n, t in
                         tensors[kind].items()}
            out["specs"][kind] = {n: tuple(s) for n, s in (
                specs["params"] if kind == "params"
                else specs["opt"].m).items()}
        torch.save(out, os.path.join(path, f"rank{self.mesh.rank}.pt"))
        self.mesh.barrier()


class LMTrainRun(LMMeshRun):
    """Rank 0's side of LM training on a ``data x model`` mesh: starts the
    helpers, joins the mesh, and runs calls on every rank (``call(name,
    *args)``: ``LMTrainProgram.op_<name>``)."""

    worker_module = "repro_torch.train.mesh_worker"

    @staticmethod
    def make_program(mesh, spec: dict):
        return LMTrainProgram(mesh, spec)

    def arrays(self, cfg, *kinds: str) -> dict:
        """The logical state as JAX pytrees, ``{kind: tree}`` for each of
        ``kinds`` (``params``, ``m``, ``v``, ``grads``), through one set of
        rank files in the run's directory."""
        from repro_torch import convert
        from repro_torch.launch.mesh import MeshLayout, ctx_for
        path = os.path.join(self.dir, "dump")
        os.makedirs(path, exist_ok=True)
        self.call("train_dump", path, kinds)
        ctx = ctx_for(MeshLayout(self.spec["data"], self.spec["model"]))
        try:
            return {kind: convert.lm_arrays_from_dumps(path, kind, cfg, ctx)
                    for kind in kinds}
        finally:
            for r in range(self.world):
                os.remove(os.path.join(path, f"rank{r}.pt"))


def main(argv=None) -> int:
    """A helper rank: ``python -m repro_torch.train.mesh_worker <run_dir>
    <rank> <parent pid>``."""
    return run_helper(argv, LMTrainProgram)


if __name__ == "__main__":
    sys.exit(main())
