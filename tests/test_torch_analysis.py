"""The port's analysis layer (``repro_torch.sparse.analysis``).

Counterparts of ``tests/test_analysis.py``:

* structural validators: valid structures pass through unchanged, and
  each seeded corruption is rejected with the *named* invariant, the
  same name the reference gives the same corruption of the same plan
  built from the same triplets;
* a tampered plan rebuilt from arrays (what a cache loader sees) is
  rejected, a valid one round-trips clean;
* the contract audit of the aten ops a hot path dispatches (16-bit
  accumulation, host synchronisation, output dtype), including a
  planted ``.item()`` and a bf16 accumulation in a wrapped fill;
* the per-kernel resource report, which replaces the VMEM-cap tests,
  and the shared-state concurrency lint;
* the warning hierarchy and the pinned rejection messages;
* the ``python -m repro_torch.sparse.analysis`` CLI on the CPU.

The retrace auditor is held in ``tests/test_torch_serving.py`` and the
sharded validators and messages in ``tests/test_torch_sharded.py``,
beside their modules.
"""
import dataclasses
import json
import pickle
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sparse as jax_sparse
from repro.sparse import InvariantViolation as JaxInvariantViolation
from repro_torch.sparse import (CacheCorruptionWarning, CapacityWarning,
                                FallbackWarning, InvariantViolation,
                                ReproWarning, convert, dispatch, plan,
                                plan_symmetric, trivial_pattern,
                                validate_matrix, validate_pattern)
from repro_torch.sparse.analysis import (audit_default_paths, audit_jaxpr,
                                         format_findings, format_table,
                                         lint_shared_state,
                                         maybe_validate_pattern, record_ops,
                                         validation_enabled,
                                         validator_for_format, vmem_report)
from repro_torch.sparse.analysis.__main__ import main as analysis_main
from repro_torch.sparse.analysis.contracts import OpRecord, OpTrace
from repro_torch.sparse.analysis.vmem import check_report
from repro_torch.sparse.pattern import (_reset_update_fallback_warning,
                                        pattern_from_arrays)
from repro_torch.sparse.spgemm import product_plan

torch.set_num_threads(1)

# the representative structure: 4x4, one duplicate at (2,2),
# structurally symmetric, block-2 aligned
ROWS = np.array([0, 1, 0, 2, 2, 2, 3])
COLS = np.array([0, 0, 1, 2, 2, 3, 2])


@pytest.fixture()
def pat():
    return plan(torch.from_numpy(ROWS), torch.from_numpy(COLS), (4, 4))


@pytest.fixture()
def A(pat):
    return pat.assemble(torch.ones(ROWS.size))


# ---------------------------------------------------------------------------
# Valid structures pass through unchanged
# ---------------------------------------------------------------------------
def test_valid_structures_validate_clean(pat, A):
    assert validate_pattern(pat) is pat
    assert validate_pattern(trivial_pattern(0, (3, 3), device="cpu")) \
        is not None
    assert validate_pattern(plan_symmetric(ROWS, COLS, (4, 4),
                                           device="cpu")) is not None
    pp = product_plan(A, A)
    assert validate_pattern(pp) is pp
    assert validate_matrix(A) is A
    for fmt in ("csr", "coo", "symcsc"):
        validate_matrix(convert(A, fmt))
    validate_matrix(convert(A, "bsr", block=2))


def test_validator_for_format_dispatch(A):
    assert validator_for_format("csc")(A) is None  # raises on failure
    with pytest.raises(KeyError):
        validator_for_format("no-such-format")


# ---------------------------------------------------------------------------
# Seeded corruptions: each caught with the right invariant name, in both
# packages
# ---------------------------------------------------------------------------
def _corruption(fields: dict, nzmax: int, invariant: str) -> dict:
    """One mutated field (numpy) per named invariant: the validator must
    fire on exactly that name, not a downstream symptom."""
    f = {k: np.array(v, copy=True) for k, v in fields.items()}
    if invariant == "indptr-monotone":
        f["indptr"][[1, 2]] = f["indptr"][[2, 1]]
    elif invariant == "perm-permutation":
        f["perm"][0] = f["perm"][1]
    elif invariant == "slot-bounds":
        f["slot"][0] = nzmax + 3
    elif invariant == "nzmax-capacity":
        f["nnz"] = np.array(nzmax + 1, np.int32)
    elif invariant == "padding-sentinel":
        f["indices"][-1] = 0
    elif invariant == "indices-bounds":
        f["indices"][0] = -1
    elif invariant == "stream-key-bounds":
        f["scols"][0] = 99
    elif invariant == "stream-sorted":
        f["srows"][[0, 1]] = f["srows"][[1, 0]]
    elif invariant != "epoch-valid":
        raise AssertionError(invariant)
    return f


FIELDS = ("perm", "slot", "indices", "indptr", "nnz", "srows", "scols")


@pytest.mark.parametrize("invariant", [
    "indptr-monotone", "perm-permutation", "slot-bounds", "epoch-valid",
    "nzmax-capacity", "padding-sentinel", "indices-bounds",
    "stream-key-bounds", "stream-sorted",
])
def test_seeded_corruption_rejected_by_name_as_in_reference(invariant):
    ref = jax_sparse.plan(ROWS, COLS, (4, 4))
    fields = {k: np.asarray(getattr(ref, k)) for k in FIELDS}
    bad = _corruption(fields, ref.nzmax, invariant)
    epoch = -1 if invariant == "epoch-valid" else 0
    port = dataclasses.replace(pattern_from_arrays(
        bad, (4, 4), device="cpu"), epoch=epoch)
    with pytest.raises(InvariantViolation) as ei:
        validate_pattern(port, subject="seeded")
    assert ei.value.invariant == invariant
    assert ei.value.subject == "seeded"
    assert f"invariant {invariant!r} violated on seeded" in str(ei.value)
    jref = dataclasses.replace(
        ref, epoch=epoch, **{k: jnp.asarray(v) for k, v in bad.items()})
    with pytest.raises(JaxInvariantViolation) as ej:
        jax_sparse.validate_pattern(jref, subject="seeded")
    assert ej.value.invariant == ei.value.invariant
    assert str(ej.value) == str(ei.value)


def test_symcsc_lower_triangle_entry_rejected(A):
    S = validate_matrix(convert(A, "symcsc"))
    # the first stored strict-upper entry is (0, 1); move its row onto
    # the diagonal so row >= col
    idx = S.indices.clone()
    idx[0] = 1
    with pytest.raises(InvariantViolation) as ei:
        validate_matrix(dataclasses.replace(S, indices=idx))
    assert ei.value.invariant == "symcsc-strict-upper"


def test_bsr_misalignment_rejected(A):
    B = validate_matrix(convert(A, "bsr", block=2))
    with pytest.raises(InvariantViolation) as ei:
        validate_matrix(dataclasses.replace(B, block=3))
    assert ei.value.invariant == "bsr-alignment"


def test_sym_pattern_selector_out_of_range():
    sp = plan_symmetric(ROWS, COLS, (4, 4), device="cpu")
    drow = sp.drow.clone()
    drow[0] = 7
    with pytest.raises(InvariantViolation) as ei:
        validate_pattern(dataclasses.replace(sp, drow=drow))
    assert ei.value.invariant == "selector-bounds"


def test_validators_read_the_device_once(pat, A, monkeypatch):
    """A validator of a plan or a format transfers its flags once."""
    calls = []
    real = torch.Tensor.tolist

    def counting(t):
        calls.append(t.shape)
        return real(t)

    monkeypatch.setattr(torch.Tensor, "tolist", counting)
    validate_pattern(pat)
    validate_matrix(A)
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# The REPRO_VALIDATE gate
# ---------------------------------------------------------------------------
def test_repro_validate_gate(monkeypatch, pat):
    bad = dataclasses.replace(pat, epoch=-1)
    monkeypatch.delenv("REPRO_VALIDATE", raising=False)
    assert not validation_enabled()
    assert maybe_validate_pattern(bad) is bad        # gate off: no check
    for off in ("0", "false", "off", ""):
        monkeypatch.setenv("REPRO_VALIDATE", off)
        assert not validation_enabled()
    monkeypatch.setenv("REPRO_VALIDATE", "1")
    assert validation_enabled()
    with pytest.raises(InvariantViolation, match="epoch-valid"):
        maybe_validate_pattern(bad)
    assert maybe_validate_pattern(pat) is pat


def test_update_validates_result_under_gate(monkeypatch):
    monkeypatch.setenv("REPRO_VALIDATE", "1")
    base = plan(torch.from_numpy(ROWS), torch.from_numpy(COLS), (4, 4),
                nzmax_slack=4)
    got = base.update(np.array([3]), np.array([3]))
    assert got.epoch == 1                            # validated clean
    # the hook runs on every rewrite: a bad merge would be named there
    import repro_torch.sparse.pattern as pattern_mod

    seen = []
    monkeypatch.setattr(
        "repro_torch.sparse.analysis.invariants.validate_pattern",
        lambda p, subject=None: seen.append(subject) or p)
    pattern_mod._maybe_validated(got)
    assert seen == ["SparsePattern.update"]


# ---------------------------------------------------------------------------
# What a cache loader sees: plans rebuilt from arrays
# ---------------------------------------------------------------------------
def test_tampered_plan_from_arrays_is_rejected(pat):
    fields = {k: getattr(pat, k).numpy() for k in FIELDS}
    bad = _corruption(pickle.loads(pickle.dumps(fields)), pat.nzmax,
                      "perm-permutation")
    with pytest.raises(InvariantViolation, match="perm-permutation"):
        validate_pattern(pattern_from_arrays(bad, (4, 4), device="cpu"),
                         subject="plan-cache entry")


def test_plan_from_arrays_roundtrip_still_validates(pat):
    fields = pickle.loads(pickle.dumps(
        {k: getattr(pat, k).numpy() for k in FIELDS}))
    again = pattern_from_arrays(fields, (4, 4), device="cpu")
    assert validate_pattern(again) is again
    for k in FIELDS:
        assert torch.equal(getattr(again, k), getattr(pat, k))


def test_plan_symmetric_accum_message_pinned():
    with pytest.raises(NotImplementedError) as ei:
        plan_symmetric(ROWS, COLS, (4, 4), accum="max", device="cpu")
    assert str(ei.value) == (
        "plan_symmetric supports accum='sum' only (got 'max'); "
        "use plan() for the plain-CSC fallback"
    )
    with pytest.raises(NotImplementedError) as ej:
        jax_sparse.plan_symmetric(ROWS, COLS, (4, 4), accum="max")
    assert str(ej.value) == str(ei.value)


# ---------------------------------------------------------------------------
# The contract audit of the dispatched aten ops
# ---------------------------------------------------------------------------
def test_audit_flags_16bit_accumulation():
    trace = record_ops(torch.cumsum, torch.ones(4, dtype=torch.bfloat16), 0)
    with pytest.raises(InvariantViolation) as ei:
        audit_jaxpr(trace, name="bf16-cumsum")
    assert ei.value.invariant == "16-bit-accumulation"
    assert ei.value.subject == "bf16-cumsum"
    # a sum into float32 of bf16 data keeps the contract
    audit_jaxpr(record_ops(lambda x: x.sum(dtype=torch.float32),
                           torch.ones(4, dtype=torch.bfloat16)))


def test_audit_flags_host_syncs():
    def noisy(x):
        return x + x.sum().item()

    trace = record_ops(noisy, torch.ones(3))
    with pytest.raises(InvariantViolation, match="host-sync"):
        audit_jaxpr(trace)
    # the same trace passes with the check opted out
    assert audit_jaxpr(trace, forbid_callbacks=False)["ok"] is True
    for compaction in (torch.nonzero, lambda x: x[x > 0],
                       lambda x: x.masked_select(x > 0)):
        with pytest.raises(InvariantViolation, match="host-sync"):
            audit_jaxpr(record_ops(compaction, torch.ones(3)))
    # indexing by positions, or a bool tensor by positions, is no sync
    flags = torch.tensor([True, False, True])
    audit_jaxpr(record_ops(lambda f: f[torch.tensor([0, 2])], flags))


def test_copy_rule_matches_on_the_overload_packet():
    """``.cpu()`` of a card tensor dispatches ``aten._to_copy`` from
    cuda to cpu: that record is a host sync; a copy within one device,
    and an op whose name merely contains "copy", are not."""
    aten = torch.ops.aten

    def rec(packet, ins, outs):
        return OpRecord(packet=packet, in_devices=ins, out_devices=outs,
                        out_dtypes=(torch.float32,), strings=())

    sync = OpTrace(records=[rec(aten._to_copy, ("cuda",), ("cpu",))],
                   outputs=())
    with pytest.raises(InvariantViolation, match="host-sync"):
        audit_jaxpr(sync)
    for r in (rec(aten._to_copy, ("cpu",), ("cpu",)),
              rec(aten.copy_, ("cuda", "cuda"), ("cuda",)),
              rec(aten._copy_from_and_resize, ("cuda", "cuda"), ("cpu",))):
        audit_jaxpr(OpTrace(records=[r], outputs=()))


def test_audit_catches_plants_in_a_wrapped_fill(pat):
    """A wrapped fill that reads a value back with ``.item()``, or sums
    bf16 values into a bf16 accumulator, is caught."""
    vals = torch.ones(pat.L, dtype=torch.bfloat16)

    def with_item(v):
        out = pat.scatter(v)
        return out * float(out.abs().max().item() > 0)

    def with_bf16_sum(v):
        out = pat.scatter(v)
        return out + torch.zeros(pat.nzmax, dtype=torch.bfloat16
                                 ).index_add_(0, pat.slot.clamp(
                                     max=pat.nzmax - 1), v[pat.perm])

    with pytest.raises(InvariantViolation) as e1:
        audit_jaxpr(record_ops(with_item, vals), name="planted .item()")
    assert e1.value.invariant == "host-sync"
    with pytest.raises(InvariantViolation) as e2:
        audit_jaxpr(record_ops(with_bf16_sum, vals), name="planted bf16")
    assert e2.value.invariant == "16-bit-accumulation"
    audit_jaxpr(record_ops(pat.scatter, vals), expect_dtype=torch.bfloat16)


def test_audit_flags_output_dtype():
    trace = record_ops(lambda x: x.to(torch.bfloat16),
                       torch.ones(3, dtype=torch.float32))
    with pytest.raises(InvariantViolation) as ei:
        audit_jaxpr(trace, expect_dtype=torch.float32)
    assert ei.value.invariant == "output-dtype"


def test_audit_sees_inside_autograd_functions():
    """The counterpart of the reference's recursion into sub-jaxprs: ops
    inside a ``torch.autograd.Function`` forward are recorded too."""
    class Acc(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return torch.cumsum(x, 0)

        @staticmethod
        def backward(ctx, g):
            return g

    trace = record_ops(Acc.apply, torch.ones(4, dtype=torch.bfloat16))
    with pytest.raises(InvariantViolation, match="16-bit-accumulation"):
        audit_jaxpr(trace, name="autograd-body")


def test_fill_path_audits_clean(pat):
    vals = torch.ones(pat.L, dtype=torch.bfloat16)
    report = audit_jaxpr(record_ops(lambda v: pat.scatter(v), vals),
                         name="fill[bf16]", expect_dtype=torch.bfloat16)
    assert report["ok"] and report["eqns"] > 0


def test_default_paths_audit_clean_on_the_cpu():
    reports = audit_default_paths(device="cpu")
    names = {r["name"] for r in reports}
    assert {"fill[sum,bfloat16]", "refill[float32]", "spgemm[bfloat16]",
            "fill_unfused[bfloat16]",
            "spmv[symcsc,float32]", "spmv[ell,float32]"} <= names
    assert len(reports) == 2 * (6 + 2) + 2 + 4


# ---------------------------------------------------------------------------
# The per-kernel resource report (replaces the VMEM-cap report)
# ---------------------------------------------------------------------------
def test_resource_report_covers_every_kernel():
    rows = vmem_report(device="cpu")
    assert {r["kernel"] for r in rows} == {
        "B1", "B2", "B3'", "B4", "B5", "B6", "B7", "B8", "B9", "B10", "B11",
        "B12"}
    for r in rows:
        assert not r["measured"] and r["registers"] is None
        assert r["threads"] > 0 and r["tile"] > 0
        assert 0 < r["max_registers"] <= 255
    # what PERF.md's ptxas lines show: B6 19.0 / 30.1 KB of static shared
    # memory in float32 / float64, B11 84 KB dynamic
    by = {r["name"]: r for r in rows}
    assert by["gather2_segment_sum_f32"]["static_smem"] == 19032
    assert by["gather2_segment_sum_f64"]["static_smem"] == 30080
    assert by["placement"]["dynamic_smem"] == 84036
    assert by["gather_segment_sum_f32"]["max_registers"] == 48


def test_resource_report_check_against_measured_columns():
    rows = [dict(r) for r in vmem_report(device="cpu")[:2]]
    for r in rows:
        r.update(measured=True, registers=r["max_registers"], spill_bytes=0,
                 static_smem_measured=r["static_smem"], blocks_per_sm=4,
                 smem_optin=232448)
    assert check_report(rows) == []
    rows[0]["registers"] = 256
    rows[1]["static_smem_measured"] += 1024
    bad = check_report(rows)
    assert len(bad) == 2 and "registers" in bad[0] and "shared" in bad[1]


def test_resource_table_renders():
    table = format_table(vmem_report(device="cpu"))
    lines = table.splitlines()
    assert lines[0].split()[:3] == ["kernel", "name", "threads"]
    assert "digit_placement_c2" in table and "block_histogram_shared" in table


def test_resource_report_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vmem_report()


# ---------------------------------------------------------------------------
# Concurrency lint
# ---------------------------------------------------------------------------
def test_concurrency_lint_port_clean():
    findings = lint_shared_state()
    assert findings == [], format_findings(findings)
    assert format_findings(findings) == "concurrency lint: clean"


def test_concurrency_lint_flags_unlocked_mutation(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text(textwrap.dedent("""\
        import threading
        _CACHE = {}
        _LOCK = threading.Lock()
        _INIT_OK = {}
        _INIT_OK["warm"] = 1          # import-time: exempt

        def good(k, v):
            with _LOCK:
                _CACHE[k] = v

        def bad_store(k, v):
            _CACHE[k] = v

        def bad_mutator(k):
            _CACHE.pop(k, None)
    """))
    findings = lint_shared_state(paths=[mod])
    assert [(f["name"], f["line"]) for f in findings] == [
        ("_CACHE", 12), ("_CACHE", 15)]
    assert "subscript store" in findings[0]["reason"]
    assert ".pop()" in findings[1]["reason"]
    assert str(mod) in format_findings(findings)


# ---------------------------------------------------------------------------
# Warning hierarchy and the fallbacks that warn
# ---------------------------------------------------------------------------
def test_warning_hierarchy():
    for w in (FallbackWarning, CapacityWarning, CacheCorruptionWarning):
        assert issubclass(w, ReproWarning)
        assert issubclass(w, RuntimeWarning)
    assert issubclass(ReproWarning, RuntimeWarning)


def test_fused_key_needs_no_overflow_fallback(recwarn):
    """The reference warns and falls back to two passes where its int32
    fused key overflows (M = N = 46341); the port's key is int64: no
    fallback, the two-pass permutation."""
    r = np.array([46340, 0, 5], np.int32)
    c = np.array([1, 46340, 1], np.int32)
    got = dispatch.sorted_permutation(torch.from_numpy(r),
                                      torch.from_numpy(c), M=46341,
                                      N=46341, method="fused")
    want = dispatch.sorted_permutation(torch.from_numpy(r),
                                       torch.from_numpy(c), M=46341,
                                       N=46341, method="jnp")
    assert torch.equal(got, want)
    assert not [w for w in recwarn if issubclass(w.category,
                                                 FallbackWarning)]


def test_update_fallback_emits_capacity_warning():
    base = plan(torch.tensor([0, 1]), torch.tensor([0, 1]), (3, 3))
    _reset_update_fallback_warning()
    try:
        with pytest.warns(CapacityWarning, match="nzmax_slack"):
            base.update(np.array([2]), np.array([2]))
    finally:
        _reset_update_fallback_warning()


# ---------------------------------------------------------------------------
# CLI driver
# ---------------------------------------------------------------------------
def test_cli_vmem_json(tmp_path, capsys):
    out = tmp_path / "vmem.json"
    assert analysis_main(["--vmem", "--json", str(out),
                          "--device", "cpu"]) == 0
    assert "kernel" in capsys.readouterr().out
    report = json.loads(out.read_text())["vmem_report"]
    assert {r["family"] for r in report} >= {"segment_sum", "radix_sort"}


def test_cli_invariants_contracts_and_concurrency(capsys):
    assert analysis_main(["--invariants", "--contracts", "--concurrency",
                          "--tuning", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "seeded corruptions rejected by name" in out
    assert "contract audit: 22 hot paths clean on cpu" in out
    assert "concurrency lint: clean" in out
    assert "tuning lint: clean" in out
