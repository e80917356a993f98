"""Multi-pod dry run: run every (arch x shape x mesh) cell on fake tensors.

The counterpart of ``repro/launch/dryrun.py``.  It shows without
hardware that the distribution config is coherent: for the 16x16
one-pod mesh and the 2x16x16 two-pod mesh, every cell's step runs over
DTensors on a ``fake`` process group (``DRYRUN_DEVICES`` ranks, default
512) and CPU ``FakeTensorMode`` tensors, so nothing is allocated and
every kernel wrapper takes its plain version, as the reference's dry
run takes XLA's ops on the CPU backend.  Where the reference reads the
compiled program, this run counts each rank's local ops:

* FLOPs by ``torch.utils.flop_counter``'s per-op formulas (the ones
  ``FlopCounterMode`` applies), per rank, and by the dtype of each op's
  first input (the plain versions take 16-bit products to float32, so
  most land under float32);
* bytes as each op's local inputs and outputs (views, allocations and
  ops that return no tensor excluded).  That count is *unfused*: every
  intermediate goes to memory and back, so it reads higher than XLA's
  fused ``bytes accessed``;
* collective bytes as the result sizes of the ``_c10d_functional``
  collectives the ranks issue, under the reference's HLO kind names;
* memory by ``torch.distributed._tools.mem_tracker.MemTracker``.

The reference fits its cost from one and two layer groups because XLA
counts a ``lax.scan`` body once (``extrapolated_cost``); the port's stack
is a Python loop, so its count is at full depth already, and the fit,
kept as the reference has it, equals it.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_5_32b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (SHAPES, CellSkipped, axis_env_for,
                                      build_cell)
from repro_torch.models.registry import ARCHS, Model, get_config
from repro_torch.models.sharding import axis_env
from repro_torch.roofline.analysis import (H100, V5E, collective_bytes_of,
                                           roofline_terms)
from repro_torch.tree import leaves


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N_active·D for inference."""
    total, active = cfg.param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq
        return 2.0 * active * tokens
    tokens = shape.global_batch * 1
    return 2.0 * active * tokens


def fake_group(n: int) -> None:
    """Make the default process group a ``fake`` one of ``n`` ranks, this
    process rank 0.  A real group stays as it is (its size must do)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            return
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


# --------------------------------------------------------------------- #
# the counter                                                            #
# --------------------------------------------------------------------- #
def _register_flop_formulas() -> None:
    """FLOP formulas of the port's two autograd operators (training's
    forward products and attention), which ``FlopCounterMode``'s table
    lacks: a product's 2 M N K, and attention's two products over every
    (query, key) pair, 4 B H Tq Tk D, as its plain version computes
    them."""
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.gemm)
    def _gemm_flops(a_shape, b_shape, *args, out_shape=None, **kw) -> int:
        batch = a_shape[0] if len(a_shape) == 3 else 1
        return 2 * batch * a_shape[-2] * a_shape[-1] * b_shape[-1]

    @register_flop_formula(torch.ops.repro_torch.flash_attention)
    def _flash_flops(q_shape, k_shape, v_shape, *args, out_shape=None,
                     **kw) -> int:
        b, h, tq, d = q_shape
        return 4 * b * h * tq * k_shape[2] * d


_register_flop_formulas()
_KINDS = (("all_reduce", "all-reduce"), ("all_gather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"))
_NO_BYTES = ("empty", "new_empty", "empty_like", "empty_strided")


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


class Counter(TorchDispatchMode):
    """Counts what each rank's local ops do: FLOPs (by the dtype of the
    op's first input), bytes and collectives.  DTensor ops are let
    through (``NotImplemented``) so that the counter sees the local ops
    they become, and the ops of DTensor's sharding propagation (run under
    a fake mode of its own) are skipped, as ``MemTracker`` skips them."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._registry = flop_registry
        self.flops = 0
        self.flops_by_dtype = {}
        self.bytes = 0
        self.coll = []                  # (kind, result bytes)

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._fake = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake:
            return out
        name = func._overloadpacket.__name__
        if func.namespace == "_c10d_functional":
            for prefix, kind in _KINDS:
                if name.startswith(prefix):
                    self.coll.append((kind, _nbytes(out)))
                    break
            else:
                if name != "wait_tensor":
                    self.coll.append((name, _nbytes(out)))
            return out
        count = self._registry.get(func._overloadpacket)
        if count is not None:
            n = int(count(*args, **kwargs, out_val=out))
            first = next((a for a in args if isinstance(a, torch.Tensor)),
                         None)
            dt = str(first.dtype).replace("torch.", "") if first is not None \
                else "?"
            self.flops += n
            self.flops_by_dtype[dt] = self.flops_by_dtype.get(dt, 0) + n
        written = _nbytes(out)
        if written and not func.is_view and name not in _NO_BYTES:
            self.bytes += _nbytes(list(args)) + written
        return out

    def cost(self) -> dict:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "coll": float(sum(b for _, b in self.coll))}


@contextlib.contextmanager
def _own_propagation_mode():
    """DTensor's sharding propagation runs each new op once on global
    shapes under the fake mode it detects, which would be the dry run's
    own and so be counted (by the counter and by ``MemTracker``) as work
    a rank does; for the ``with`` block it takes a fake mode of its own,
    which both skip."""
    from torch.distributed.tensor import _sharding_prop
    detect = _sharding_prop.detect_fake_mode
    _sharding_prop.detect_fake_mode = lambda *args: None
    try:
        yield
    finally:
        _sharding_prop.detect_fake_mode = detect


def count_cell(cell, *, memory: bool = False):
    """Run ``cell`` (under the fake mode it was built in) counting it:
    ``(Counter, memory record or None, wall seconds)``."""
    t0 = time.time()
    mem = None
    counter = Counter()
    if memory:
        from torch.distributed._tools.mem_tracker import MemTracker
        tracker = MemTracker()
        args = leaves(list(cell.args))
        tracker.track_external(*[a for a in args
                                 if isinstance(a, torch.Tensor)])
        arg_bytes = sum(_local_bytes(a) for a in args)
        with _own_propagation_mode(), counter, tracker:
            out = cell.fn(*cell.args)
        peak = tracker.get_tracker_snapshot("peak")
        total = {str(dev): int(snap.get("Total", 0))
                 for dev, snap in peak.items()}
        mem = {"argument_size_in_bytes": arg_bytes,
               "output_size_in_bytes": sum(
                   _local_bytes(a) for a in leaves(list(out))),
               "peak_size_in_bytes": max(total.values(), default=0),
               "peak_by_kind": {str(k): int(v) for dev, snap in peak.items()
                                for k, v in snap.items()},
               "generated_code_size_in_bytes":
                   "not applicable: eager PyTorch compiles no program"}
    else:
        with _own_propagation_mode(), counter:
            cell.fn(*cell.args)
    return counter, mem, time.time() - t0


def _local_bytes(x) -> int:
    if not isinstance(x, torch.Tensor):
        return 0
    from repro_torch.models.sharding import is_dtensor
    return _nbytes(x.to_local() if is_dtensor(x) else x)


# --------------------------------------------------------------------- #
# the reference's depth fit, kept                                        #
# --------------------------------------------------------------------- #
def _with_groups(cfg, k: int):
    from repro_torch.models.transformer import period_of
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=k, encoder_layers=k)
    period = period_of(cfg)
    return dataclasses.replace(cfg, n_layers=k * period)


def _n_groups(cfg) -> int:
    from repro_torch.models.transformer import period_of
    if cfg.family == "encdec":
        return cfg.n_layers
    return cfg.n_layers // period_of(cfg)


def _cost_probe(cfg, shape_name, mesh, k: int, **cell_kw) -> dict:
    """Count the k-group variant; per-rank FLOPs, bytes and collective
    bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    sub = _with_groups(cfg, k)
    model = Model.from_config(sub)
    with FakeTensorMode():
        cell = build_cell(model, sub.name, shape_name, mesh, unroll=True,
                          **cell_kw)
        counter, _, _ = count_cell(cell)
    return counter.cost()


def extrapolated_cost(cfg, shape_name, mesh, **cell_kw) -> dict:
    k_full = _n_groups(cfg)
    c1 = _cost_probe(cfg, shape_name, mesh, 1, **cell_kw)
    if k_full == 1:
        c1["probe_k1"] = dict(c1)
        return c1
    c2 = _cost_probe(cfg, shape_name, mesh, 2, **cell_kw)
    out = {}
    for key in c1:
        slope = c2[key] - c1[key]
        out[key] = max(0.0, c1[key] + slope * (k_full - 1))
    out["probe_k1"] = c1           # intercept: embed/loss/optimizer
    out["probe_k2"] = c2           # +1 layer group: per-layer slope
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             remat: str = "dots", n_micro: int = 1, zero: bool = False,
             grad_compress: bool = False, moe_impl: str = "scatter",
             overrides: Optional[dict] = None,
             out_dir: Optional[str] = None, verbose: bool = True,
             tag: str = "", mesh=None) -> dict:
    """One cell's record.  ``mesh`` replaces the production mesh (a
    small debug mesh); the fake group must then hold its ranks."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mesh_name = "multi" if multi_pod else "single"
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    model = Model.from_config(cfg)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "remat": remat, "n_micro": n_micro, "zero": zero,
           "grad_compress": grad_compress, "moe_impl": moe_impl,
           "overrides": overrides or {}, "tag": tag,
           "status": "?"}
    t0 = time.time()
    kw = dict(remat=remat, n_micro=n_micro, zero=zero,
              grad_compress=grad_compress, moe_impl=moe_impl)
    try:
        if mesh is None:
            fake_group(int(os.environ.get("DRYRUN_DEVICES", "512")))
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        else:
            mesh_name = "x".join(map(str, mesh.shape))
            rec["mesh"] = mesh_name
        with axis_env(axis_env_for(mesh)):
            with FakeTensorMode():
                cell = build_cell(model, arch, shape_name, mesh, **kw)
                t_build = time.time() - t0
                counter, mem, t_run = count_cell(cell, memory=True)
            rec["memory"] = mem
            rec["collectives"] = collective_bytes_of(counter.coll)
            rec["collective_ops"] = len(counter.coll)
            rec["cost_raw"] = {"flops": float(counter.flops),
                               "bytes accessed": float(counter.bytes)}
            rec["flops_by_dtype"] = dict(counter.flops_by_dtype)
            # the reference's depth fit (see extrapolated_cost)
            fit = extrapolated_cost(cfg, shape_name, mesh, **kw)
        rec["cost"] = {"flops": fit["flops"], "bytes accessed": fit["bytes"]}
        rec["coll_bytes_fit"] = fit["coll"]
        rec["probes"] = {k: fit[k] for k in ("probe_k1", "probe_k2")
                         if k in fit}
        chips = mesh.size()
        for key, spec in (("roofline", V5E), ("roofline_h100", H100)):
            rep = roofline_terms(
                arch=arch, shape=shape_name, mesh_name=mesh_name,
                chips=chips, cost=rec["cost"], hlo_text="",
                model_flops=model_flops_for(cfg, shape),
                coll_bytes=fit["coll"], spec=spec)
            rec[key] = rep.row()
        rec["chips"] = chips
        rec["build_s"] = round(t_build, 1)
        rec["run_s"] = round(t_run, 1)
        rec["status"] = "ok"
    except CellSkipped as e:
        rec["status"] = "skipped"
        rec["reason"] = str(e)
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["wall_s"] = round(time.time() - t0, 1)

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        path = os.path.join(out_dir,
                            f"{arch}__{shape_name}__{mesh_name}{suffix}"
                            ".json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    if verbose:
        r = rec.get("roofline", {})
        print(f"[{rec['status']:7s}] {arch:24s} {shape_name:12s} "
              f"{mesh_name:6s} wall={rec['wall_s']:7.1f}s "
              f"dom={r.get('dominant', '-'):10s} "
              f"frac={r.get('roofline_fraction', 0):.3f}"
              + (f"  ERR {rec.get('error', '')[:120]}"
                 if rec["status"] == "error" else ""))
        if rec["status"] == "ok":
            for key, name in (("roofline", "V5E "), ("roofline_h100",
                                                     "H100")):
                r = rec[key]
                print(f"          {name} dom={r['dominant']:10s} "
                      f"frac={r['roofline_fraction']:.3f} "
                      f"compute={r['t_compute_s']:.6f}s "
                      f"memory={r['t_memory_s']:.6f}s (unfused bytes) "
                      f"collective={r['t_collective_s']:.6f}s "
                      f"useful={r['useful_flops_ratio']:.4f}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="dots",
                    choices=["none", "dots", "full"])
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--zero", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--moe-impl", default="scatter",
                    choices=["scatter", "dense", "a2a"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                results.append(run_cell(
                    arch, shape, mp, remat=args.remat,
                    n_micro=args.n_micro, zero=args.zero,
                    grad_compress=args.grad_compress,
                    moe_impl=args.moe_impl, out_dir=args.out))
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"of {len(results)} cells")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
