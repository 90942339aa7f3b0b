"""Multi-pod dry run: trace every (arch x shape x mesh) cell's real step
on fake tensors placed on the production mesh (counterpart of
``repro/launch/dryrun.py``).

For each cell this:
  1. makes the production mesh (16x16 single-pod / 2x16x16 multi-pod) as
     a ``DeviceMesh`` over ``torch.distributed``'s ``"fake"`` process
     group of 256 or 512 ranks, which takes the place of the reference's
     512 forced host devices (one group per process: with ``--mesh
     both`` or ``--jobs N`` every cell runs in a child process),
  2. builds the state under ``FakeTensorMode`` (no allocation) and
     places every leaf with ``distribute_tensor`` by the rules of
     ``launch/sharding.py``,
  3. runs the port's real ``train_step``, ``prefill`` or
     ``decode_step`` on those DTensors,
  4. records what rank 0 holds and does: its shards' bytes in and out,
     the peak of the bytes it allocates, its own FLOPs and the census of
     the collectives the step issued, under the reference's keys.

The reference compiles, and reads XLA's memory and cost analyses; the
port traces instead (``trace_s`` replaces ``lower_s`` and
``compile_s``).  ``flops`` counts the ops each rank runs on its local
shards (``torch.utils.flop_counter``'s formulas), not the global count
``FlopCounterMode`` gives over DTensors.  ``transcendentals`` is 0 and
``bytes_accessed`` is -1, the reference's value where XLA reports none.

The MoE dispatch and the embedding gradient run their B12/B11 custom ops
on each rank's local tokens under ``local_map`` (``models/moe.py``,
``train/sparse_grads.py``).  Plain tensors the model makes (positions,
masks) join the DTensors as replicated (``implicit_replication``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --jobs 8 --out experiments/dryrun
  python -m repro_torch.launch.dryrun --cells olmo_1b:decode_32k:multi ...
  (``--device cpu`` makes the meshes on the CPU: the tests only; the
  census of a CPU mesh records an all-to-all as an all-gather)
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
import weakref

import torch

from ..configs import ARCHS, get_config
from ..models import model as _model
from ..models import runtime_flags as _rtf
from ..models.config import SHAPES
from ..models.model import decode_step, init_cache, init_model, prefill
from ..train.optimizer import OptConfig
from ..train.train_step import TrainConfig, init_train_state, make_train_step
from .mesh import dp_size, make_production_mesh
from .sharding import (
    P,
    batch_specs_for,
    cache_specs,
    logits_spec,
    map_with_path,
    param_bytes,
    param_specs,
    place,
    place_cache,
    place_tokens,
    placements,
    serving_mode,
)
from .specs import cell_applicable, input_specs

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

#: ``_c10d_functional`` ops (what DTensor issues) -> the census's names
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def collective_census(records) -> dict[str, dict[str, float]]:
    """Sum the *result* sizes of the collectives a trace issued.

    ``records`` holds ``(op, result_bytes)`` pairs; ``op`` is a census
    name (``"all-gather"``, ...) or the ``_c10d_functional`` op that
    DTensor issues (``"all_gather_into_tensor"``, ...).  The schema is
    the reference's: each kind's ``count`` and ``bytes``, and
    ``total_bytes``.
    """
    census: dict[str, dict[str, float]] = {
        k: {"count": 0, "bytes": 0} for k in _COLLECTIVES
    }
    for op, nbytes in records:
        kind = op if op in census else _FUNCTIONAL[op]
        census[kind]["count"] += 1
        census[kind]["bytes"] += int(nbytes)
    census["total_bytes"] = sum(
        v["bytes"] for k, v in census.items() if isinstance(v, dict)
    )
    return census


# ---------------------------------------------------------------------------
# The fake process group
# ---------------------------------------------------------------------------
def init_fake_group(world_size: int) -> None:
    """The default process group on the ``"fake"`` backend: ``world_size``
    ranks, this process rank 0, collectives that move nothing."""
    import torch.distributed as dist
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:  # pragma: no cover - depends on the build
        raise RuntimeError(
            "the dry run needs torch.testing._internal.distributed.fake_pg "
            f"(the 'fake' process group), which this torch lacks: {e}"
        ) from e
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


# ---------------------------------------------------------------------------
# What a rank does: local FLOPs, live bytes, collectives
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _dtensor_bookkeeping(rec):
    """DTensor's own bookkeeping during the trace, kept out of the
    rank's counts: it derives an op's global output shape by running the
    op once on global-shaped fake tensors (not the rank's work), and it
    sizes a strided shard from an index tensor, which must be a real
    (tiny) tensor: under ``FakeTensorMode`` it would be data-dependent.

    DTensor also takes any ``FakeTensorMode`` for a compiler's trace with
    symbolic shapes and then caches none of its sharding decisions; the
    dry run's shapes are all static, so the caches stay on (a train step
    of a 3-d mesh would otherwise search its redistributions afresh for
    every op)."""
    import torch.distributed.tensor._dispatch as dispatch_mod
    import torch.distributed.tensor._redistribute as redistribute_mod
    import torch.distributed.tensor._sharding_prop as prop_mod
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard

    tracing = [(m, m._are_we_tracing)
               for m in (dispatch_mod, redistribute_mod, prop_mod)]

    def paused(fn, real=False):
        def wrapped(*args, **kwargs):
            rec.paused += 1
            try:
                if real:
                    with unset_fake_temporarily():
                        return fn(*args, **kwargs)
                return fn(*args, **kwargs)
            finally:
                rec.paused -= 1
        return wrapped

    patches = [
        (ShardingPropagator, "_propagate_tensor_meta_non_cached", False),
        (_StridedShard, "local_shard_size_and_offset", True),
    ]
    saved = [(cls, name, cls.__dict__[name]) for cls, name, _ in patches]
    try:
        for cls, name, real in patches:
            orig = cls.__dict__[name]
            fn = orig.__func__ if isinstance(orig, staticmethod) else orig
            w = paused(fn, real)
            setattr(cls, name, staticmethod(w)
                    if isinstance(orig, staticmethod) else w)
        for m, _ in tracing:
            m._are_we_tracing = _static_shapes
        yield
    finally:
        for cls, name, orig in saved:
            setattr(cls, name, orig)
        for m, orig in tracing:
            m._are_we_tracing = orig


def _static_shapes() -> bool:
    return False


def _recorder_class():
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import flop_registry

    class Recorder(TorchDispatchMode):
        """Sees the ops a rank runs on its local (fake) tensors: a DTensor
        op goes on to DTensor's dispatch, whose local ops come back here.
        Counts their FLOPs, the bytes of the storages they allocate
        (live until the storage dies) and the collectives."""

        def __init__(self):
            super().__init__()
            self.flops = 0
            self.live = 0
            self.peak = 0
            self.paused = 0
            self.collectives = []
            self._seen = set()

        def hold(self, tensors):
            """Storages that live before the step (its arguments): an
            op that writes into them allocates nothing."""
            self._seen.update(t.untyped_storage()._cdata for t in tensors)

        def _free(self, key, nbytes):
            self._seen.discard(key)
            self.live -= nbytes

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            if self.paused:
                return out
            pkt = func._overloadpacket
            if pkt in flop_registry:
                self.flops += flop_registry[pkt](*args, **kwargs,
                                                 out_val=out)
            outs = [t for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            for t in outs:
                if t.device.type == "meta":  # a template: no memory
                    continue
                st = t.untyped_storage()
                key = st._cdata
                if key in self._seen:
                    continue
                self._seen.add(key)
                nbytes = st.nbytes()
                self.live += nbytes
                weakref.finalize(st, self._free, key, nbytes)
            self.peak = max(self.peak, self.live)
            if func.namespace == "_c10d_functional" and \
                    pkt.__name__ in _FUNCTIONAL:
                self.collectives.append(
                    (pkt.__name__, sum(t.numel() * t.element_size()
                                       for t in outs)))
            return out

    return Recorder


def _local(tree) -> list:
    """The rank's own tensors of ``tree``: a DTensor's local shard."""
    return [getattr(t, "_local_tensor", t) for t in _leaves(tree)]


def local_bytes(tree) -> int:
    """The bytes of the rank's own shards of every tensor in ``tree``."""
    return sum(t.numel() * t.element_size() for t in _local(tree))


def _leaves(tree) -> list:
    out = []
    map_with_path(lambda name, leaf, blocks: out.append(leaf), tree)
    return [t for t in out if isinstance(t, torch.Tensor)]


# ---------------------------------------------------------------------------
# Templates placed on the mesh (``sharding.place``)
# ---------------------------------------------------------------------------
_place = place


def _fake_like(spec_tree, device):
    """Zero fake tensors shaped as ``input_specs``' meta tensors."""
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
            for k, v in spec_tree.items()}


def _trace_once(fn, args, fake_mode, grad: bool) -> dict:
    """Run ``fn(*args)`` once under the recorder: what rank 0 does."""
    from torch.distributed.tensor.experimental import implicit_replication

    rec = _recorder_class()()
    rec.hold(_local(args))
    with fake_mode, implicit_replication(), _dtensor_bookkeeping(rec), \
            rec, torch.set_grad_enabled(grad):
        out = fn(*args)
    census = collective_census(rec.collectives)
    return {"output_bytes": local_bytes(out), "temp_bytes": rec.peak,
            "flops": rec.flops, "census": census, "out": out}


def _extrapolate(a: dict, b: dict, k: int) -> dict:
    """``a + k (b - a)`` for every count of two traces (``k`` steps past
    ``a``); the outputs are ``b``'s."""
    def ext(x, y):
        if isinstance(x, dict):
            return {key: ext(x[key], y[key]) for key in x}
        return x + k * (y - x)

    out = {key: ext(a[key], b[key])
           for key in ("temp_bytes", "flops", "census")}
    return dict(b, **out)


@dataclasses.dataclass
class Lowered:
    """One cell's step, ready to trace: ``fn(*args)`` on DTensors, with
    the placements the reference's ``out_shardings`` ask for.

    A train step of ``n > 3`` microbatches is traced at two and three
    (``traced``: the step and its arguments for each) and its counts are
    the line through those two: its microbatches are alike and each
    one's activations are freed before the next begins, so every count
    (FLOPs, collectives' counts and bytes, the peak of live bytes) grows
    by the same amount per microbatch.  The tests hold this against the
    whole step: exact, but for the peak, which may miss a loss scalar
    (4 bytes) a microbatch."""

    fn: object
    args: tuple
    arg_names: tuple
    out_specs: object
    mesh: object
    fake_mode: object
    grad: bool
    traced: tuple = ()
    microbatches: int = 0

    def trace(self) -> dict:
        """What rank 0 holds and does in the step."""
        arg_bytes = local_bytes(self.args)
        if not self.traced:
            rec = _trace_once(self.fn, self.args, self.fake_mode, self.grad)
        else:
            (f2, a2), (f3, a3) = self.traced
            two = _trace_once(f2, a2, self.fake_mode, self.grad)
            three = _trace_once(f3, a3, self.fake_mode, self.grad)
            rec = _extrapolate(two, three, self.microbatches - 2)
        return dict(rec, argument_bytes=arg_bytes, argument_bytes_by_input={
            n: local_bytes(a) for n, a in zip(self.arg_names, self.args)})


def build_lowered(arch: str, shape_name: str, mesh, *, microbatches=None,
                  extrapolate: bool = True):
    """Construct one cell's step on DTensors (no trace yet).  A train
    step of more than three microbatches is traced at two and three and
    extrapolated (:class:`Lowered`), unless ``extrapolate`` is false."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return None, why

    # §Perf iteration 5/7: shard-local MoE dispatch (local_map)
    _rtf.set_moe_dispatch(cfg, mesh, shape.global_batch)

    specs = input_specs(cfg, shape_name)
    dev = mesh.device_type
    # kv chunking: bound attention working set; bigger chunk for decode.
    kv_chunk = 2048 if shape.seq_len > 8192 else 1024
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)

    if shape.kind == "train":
        if microbatches is not None:
            mb = microbatches
        elif cfg.d_model >= 3584:
            # §Perf: the two big-model train cells (dbrx, zamba2) blow the
            # 16 GiB temp envelope at mb=8 -> halve the live microbatch.
            mb = 16 if shape.global_batch >= 64 else 1
        else:
            mb = 8 if shape.global_batch >= 64 else 1
        tcfg = TrainConfig(
            opt=OptConfig(), microbatches=mb, compress_grads=True,
            kv_chunk=kv_chunk,
        )
        # the microbatches alike only where every one of them spreads
        # over all the batch shards (train_step._split_microbatches)
        dp = dp_size(mesh) if shape.global_batch % dp_size(mesh) == 0 else 1
        short = extrapolate and mb > 3 and (shape.global_batch // mb) % dp == 0
        with fake_mode:
            state_tpl = init_train_state(init_model(cfg, device="cpu"), tcfg)
            state_specs = param_specs(mesh, state_tpl)
            state = _place(mesh, state_tpl, state_specs)
            batches = {}
            for n in ((mb, 2, 3) if short else (mb,)):
                rows = shape.global_batch // mb * n
                tpl = {k: torch.zeros((rows, *v.shape[1:]), dtype=v.dtype,
                                      device=dev)
                       for k, v in specs["batch"].items()}
                batches[n] = _place(mesh, tpl, batch_specs_for(
                    mesh, tpl, batch=shape.global_batch))
        del state_tpl
        traced = tuple(
            (make_train_step(cfg, dataclasses.replace(tcfg, microbatches=n)),
             (state, batches[n])) for n in (2, 3)) if short else ()
        return Lowered(make_train_step(cfg, tcfg), (state, batches[mb]),
                       ("state", "batch"), (state_specs, P()), mesh,
                       fake_mode, True,
                       traced=traced, microbatches=mb), ""

    with fake_mode:
        params_tpl = init_model(cfg, device="cpu")
    # serving replicates weights over "data" (TP only) — see sharding.py —
    # but only when weights/TP fit the HBM budget; dbrx-132b (16.5 GiB/dev
    # TP-only) keeps FSDP sharding + per-layer gathers instead.
    p_specs = param_specs(mesh, params_tpl, mode=serving_mode(
        mesh, param_bytes(params_tpl)))
    with fake_mode:
        params = _place(mesh, params_tpl, p_specs)
    del params_tpl
    l_spec = logits_spec(mesh, batch=shape.global_batch)

    if shape.kind == "prefill":
        with fake_mode:
            batch_tpl = _fake_like(specs["batch"], dev)
            batch = _place(mesh, batch_tpl, batch_specs_for(
                mesh, batch_tpl, batch=shape.global_batch))
            cache_tpl = init_cache(cfg, batch=shape.global_batch,
                                   seq_len=shape.seq_len, device="meta")
        c_specs = cache_specs(mesh, cache_tpl, cfg, batch=shape.global_batch)
        return Lowered(
            lambda p, b: prefill(p, b, cfg, kv_chunk=kv_chunk),
            (params, batch), ("params", "batch"), (l_spec, c_specs), mesh,
            fake_mode, False), ""

    # decode
    c_specs = cache_specs(mesh, specs["cache"], cfg,
                          batch=shape.global_batch)
    with fake_mode:
        cache_tpl = init_cache(cfg, batch=shape.global_batch,
                               seq_len=shape.seq_len, device=dev)
        cache = place_cache(mesh, cache_tpl, cfg, batch=shape.global_batch)
        tokens = place_tokens(mesh, torch.zeros(
            specs["tokens"].shape, dtype=specs["tokens"].dtype, device=dev))
    del cache_tpl
    return Lowered(
        lambda p, c, t: decode_step(p, c, t, cfg),
        (params, cache, tokens), ("params", "cache", "tokens"),
        (l_spec, c_specs), mesh, fake_mode, False), ""


def placement_mismatches(mesh, out, out_specs) -> list[str]:
    """Where the traced outputs' placements differ from the placements
    the reference's ``out_shardings`` ask for.  A train step's are
    recorded here, not forced.  ``prefill`` and ``decode_step`` force
    theirs (``models.model._served_layout``), so for them this finds
    nothing: :func:`run_cell` adds what that function moved
    (``models.model.LAYOUT_FIXES``)."""
    from torch.distributed.tensor import DTensor

    got, want = [], []
    map_with_path(lambda n, leaf, b: got.append((n, leaf)), _as_tree(out))
    map_with_path(lambda n, leaf, b: want.append(leaf), _as_tree(out_specs))
    diffs = []
    for (name, t), spec in zip(got, want):
        if not isinstance(t, DTensor) or not isinstance(spec, P):
            continue
        exp = placements(mesh, spec)
        if tuple(t.placements) != exp:
            diffs.append(f"{name}: {tuple(t.placements)} != {exp}")
    return diffs


def _as_tree(x):
    if isinstance(x, (tuple, list)) and not isinstance(x, P):
        return {str(i): _as_tree(v) for i, v in enumerate(x)}
    return x


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str | None,
             *, device=None):
    multi = mesh_kind == "multi"
    init_fake_group(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device=device)
    t0 = time.time()
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "status": "ok",
    }
    try:
        lowered, why = build_lowered(arch, shape_name, mesh)
        if lowered is None:
            result["status"] = "skipped"
            result["reason"] = why
            print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: SKIP ({why})")
            return result
        _model.LAYOUT_FIXES.clear()
        rec = lowered.trace()
        t1 = time.time()
        census = rec["census"]
        result.update(
            trace_s=round(t1 - t0, 2),
            memory=dict(
                argument_bytes=int(rec["argument_bytes"]),
                output_bytes=int(rec["output_bytes"]),
                temp_bytes=int(rec["temp_bytes"]),
                generated_code_bytes=0,
            ),
            argument_bytes_by_input=rec["argument_bytes_by_input"],
            flops=float(rec["flops"]),
            transcendentals=0.0,
            bytes_accessed=-1.0,
            collectives=census,
            placement_mismatches=placement_mismatches(
                mesh, rec["out"], lowered.out_specs) + list(
                    dict.fromkeys(_model.LAYOUT_FIXES)),
        )
        print(
            f"[dryrun] {arch} x {shape_name} x {mesh_kind}: OK "
            f"trace={t1 - t0:.1f}s flops={result['flops']:.3e} "
            f"coll={census['total_bytes']:.3e}B "
            f"temp={result['memory']['temp_bytes']/2**30:.2f}GiB"
        )
    except Exception as e:  # noqa: BLE001 - report, continue the sweep
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-2000:]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: ERROR {e}")
    finally:
        _rtf.set_moe_groups(1)
        _rtf.set_moe_mesh(None)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            fn = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
            with open(fn, "w") as f:
                json.dump(result, f, indent=1, default=str)
    return result


def _cell_in_child(arch, shape, mesh_kind, out_dir, device) -> dict:
    """One cell in a process of its own (each process holds one fake
    process group); its printed line is passed on."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh_kind, "--out", out_dir]
    if device is not None:
        cmd += ["--device", device]
    p = subprocess.run(cmd, capture_output=True, text=True)
    sys.stdout.write("".join(line + "\n" for line in p.stdout.splitlines()
                             if not line.startswith("[dryrun] done:")))
    sys.stdout.flush()
    fn = os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}.json")
    if os.path.exists(fn):
        with open(fn) as f:
            return json.load(f)
    return {"arch": arch, "shape": shape, "mesh": mesh_kind,
            "status": "error",
            "error": f"the cell's process exited {p.returncode}",
            "traceback": p.stderr[-2000:]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--device", default=None,
                    help="the meshes' device type (default: cuda; 'cpu' "
                         "for the tests)")
    ap.add_argument("--cells", nargs="*", default=None,
                    metavar="ARCH:SHAPE:MESH",
                    help="trace exactly these cells (instead of --arch, "
                         "--shape, --mesh, --all)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its "
                         "own (also the case for --mesh both)")
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]
    if args.cells is not None:
        cells = [tuple(c.split(":")) for c in args.cells]
        meshes = sorted({m for _, _, m in cells})

    if args.jobs > 1 or len(meshes) > 1:
        # one process group per process: every cell in a child
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max(1, args.jobs)) as pool:
            results = list(pool.map(
                lambda c: _cell_in_child(*c, args.out, args.device), cells))
    else:
        results = [run_cell(*c, args.out, device=args.device)
                   for c in cells]
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
