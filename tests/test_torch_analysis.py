"""repro_torch's linter (``python -m repro_torch.analysis``) against the JAX
package's ``repro.analysis`` and its own fixtures, on the CPU.

The AST layer finds the same (rule, line) pairs as the JAX linter on the
shared fixtures (``tests/fixtures/analysis``) and torch's host syncs and
tensor branches on its own (``tests/fixtures/analysis_torch``); the
Hopper budget agrees with the kernels' plan functions for every Table-I
config and table dtype; the semantic rules pass on the live port and catch
a rebinding optimizer; the report validates against the JAX linter's
schema; the CLI's exit codes are the JAX CLI's.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.analysis import ast_rules as jast_rules  # noqa: F401
from repro.analysis import registry as jregistry
from repro_torch.analysis import budget, registry, torch_rules
from repro_torch.core.fields import make_field_config
from repro_torch.core.mlp import MLPConfig
from repro_torch.kernels.fused_field import fused_field
from repro_torch.kernels.fused_mlp import fused_mlp
from repro_torch.kernels.hashgrid import hashgrid
from repro_torch.kernels.ray_march import ray_march
from repro_torch.obs import export
from repro_torch.train import optim

REPO = Path(__file__).resolve().parents[1]
SHARED = REPO / "tests" / "fixtures" / "analysis"
FIX = REPO / "tests" / "fixtures" / "analysis_torch"
SCHEMA = REPO / "benchmarks" / "schemas" / "analysis_report.schema.json"


def run_ast(path, rules=None):
    return registry.run_paths([str(path)], rules=rules, semantic=False)


def pairs(findings):
    return sorted((f.rule, f.line, f.suppressed) for f in findings)


# ------------------------------------------------------------ AST rules
@pytest.mark.parametrize("fixture", ["bad_mutable_default.py", "bad_print.py",
                                     "suppressed.py", "good_clean.py"])
def test_shared_fixtures_match_the_jax_linter(fixture):
    path = str(SHARED / fixture)
    ours = run_ast(path)
    theirs = jregistry.run_paths([path], semantic=False)
    assert pairs(ours) == pairs(theirs)
    assert [f.suppress_reason for f in ours if f.suppressed] == [
        f.suppress_reason for f in theirs if f.suppressed]


def test_host_sync_positives():
    fs = run_ast(FIX / "bad_torch_sync.py", rules=["host-sync"])
    assert {f.code for f in fs} == {"RA101"}
    assert not any(f.suppressed for f in fs)
    # the three explicit syncs, then every pull in the hot path; float(x)
    # of a parameter (line 27) is not shown a tensor
    assert sorted(f.line for f in fs) == [7, 8, 9, *range(15, 23),
                                          24, 25, 26]


def test_tensor_branch_positives_and_negatives():
    fs = run_ast(FIX / "bad_tensor_branch.py", rules=["tensor-branch"])
    assert [(f.code, f.line) for f in sorted(fs, key=lambda f: f.line)] == [
        ("RA102", 9), ("RA102", 11)]


def test_allowed_calls_are_clean():
    """The same calls in a sync boundary (and its closure), after .shape
    and .numel() reads, outside the hot path, or under allow[...]."""
    fs = run_ast(FIX / "good_torch_clean.py")
    assert [f for f in fs if not f.suppressed] == []
    assert pairs(fs) == [("host-sync", 26, True), ("host-sync", 27, True),
                         ("tensor-branch", 29, True)]


def test_rule_names_are_the_jax_suppression_tokens():
    """One allow[...] line serves both linters where the meaning carries
    over: the engine's allow[host-sync] on its host-numpy conversion is a
    suppressed finding of both."""
    from repro_torch.analysis import ast_rules  # noqa: F401
    ours = {r.code: r.name for r in registry.RULES.values()}
    jax = {r.code: r.name for r in jregistry.RULES.values()}
    for code in ("RA101", "RA104", "RA105"):
        assert ours[code] == jax[code]
    engine = str(REPO / "src" / "repro_torch" / "serve" / "engine.py")
    for run in (run_ast, lambda p: jregistry.run_paths([p], semantic=False)):
        sup = [f for f in run(engine) if f.suppressed]
        assert [(f.rule, f.suppress_reason) for f in sup] == [
            ("host-sync", "request ids arrive as host numpy")]


# ----------------------------------------------------- budget (RT201)
def _group_bytes(grid, dtype, g):
    """Bytes one group of g levels reaches at most, worked out here from
    the level resolutions: all T rows of a hashed level, (res + 1)^d of a
    dense one (at most T)."""
    row = grid.n_features * dtype.itemsize
    per_level = []
    for level in range(grid.n_levels):
        res = grid.level_resolution(level)
        rows = (grid.table_size if grid.level_is_hashed(level)
                else min(grid.table_size, (res + 1) ** grid.dim))
        per_level.append(rows * row)
    return max(sum(per_level[l:l + g])
               for l in range(0, grid.n_levels, g))


@pytest.mark.parametrize("app", budget.FIELD_APPS)
@pytest.mark.parametrize("encoding", budget.FIELD_ENCODINGS)
@pytest.mark.parametrize("dtype", budget.TABLE_DTYPES,
                         ids=lambda d: str(d).replace("torch.", ""))
def test_budget_agrees_with_the_plans(app, encoding, dtype):
    cfg = make_field_config(app, encoding)
    grid = cfg.grid
    ests = budget.estimate_config(app, encoding, dtype)
    kinds = sorted({(e.kernel, e.route) for e in ests})
    trainable = dtype in budget.TRAINABLE_DTYPES
    field = "field_fwd" if trainable else "field_fwd_q"
    want = {(field, "serve"), ("encode_fwd", "serve"), ("mlp_fwd", "serve")}
    if app in ("nerf", "nvr"):
        want.add(("composite_fwd", "serve"))
    if trainable:
        want |= {(field, "train"), ("encode_fwd", "train"),
                 ("encode_bwd", "train")}
        if app == "nerf":
            want.add(("mlp_fwd", "train"))
    assert kinds == sorted(want)
    for e in ests:
        n_rays = 4096 if e.route == "serve" else 2048
        ray = app in ("nerf", "nvr") and e.kernel != "composite_fwd"
        assert e.n_points == n_rays * (32 if ray else 1)
        if e.kernel == "encode_fwd":
            plan = hashgrid.encode_plan(grid, dtype, e.n_points, 132)
            assert e.level_group == plan["group_levels"]
            assert e.group_bytes == _group_bytes(grid, dtype, e.level_group)
            assert e.share_bytes == 16 << 20
            assert (e.threads, e.smem_bytes) == (128, 0)
        elif e.kernel == "encode_bwd":
            plan = hashgrid.encode_bwd_plan(grid, e.n_points, 132)
            assert e.level_group == plan["group_levels"]
            assert e.group_bytes == _group_bytes(grid, torch.float32,
                                                 e.level_group)
            assert e.share_bytes == 8 << 20
        elif e.kernel.startswith("field_fwd"):
            head = cfg.density_mlp if app == "nerf" else cfg.mlp
            stride = 8 * -(-head.in_dim // 8) + 8
            assert e.smem_bytes == (fused_mlp.weight_bytes(head, 64)
                                    + 2 * 128 * stride * 4)
            assert e.smem_bytes == fused_field.field_plan(head)["smem_bytes"]
            assert e.threads == 512
        elif e.kernel == "mlp_fwd":
            assert e.smem_bytes in {
                fused_mlp.mlp_plan(m)["smem_bytes"]
                for m in (cfg.mlp, cfg.density_mlp) if m is not None}
            assert e.threads == 512
        else:
            assert e.plan == ray_march.composite_plan(32)
            assert (e.threads, e.smem_bytes) == (256, 0)


def test_budget_verdicts_clean_at_defaults():
    """No errors at the shipped plans: every miss is a documented degrade
    (a warning), at the smallest group the kernel takes: the 3-D tiled
    grids' backward, whose 16 MiB levels are over the 8 MiB share."""
    ests = budget.table1_estimates()
    assert len(ests) == 258
    degraded = [e for e in ests if e.verdict != "fits"]
    assert {e.verdict for e in degraded} == {"degraded"}
    assert sorted((e.kernel, e.app, e.encoding, e.dtype)
                  for e in degraded) == sorted(
        ("encode_bwd", app, "tiled", dt) for app in ("nerf", "nsdf", "nvr")
        for dt in ("float32", "bfloat16"))
    assert all(e.level_group == e.min_group == 1 for e in degraded)
    findings = budget.check()
    assert [f for f in findings if f.severity == "error"] == []
    assert len(findings) == 6


def test_budget_drift_is_an_error(monkeypatch):
    """A picker that takes a larger group than fits makes an error."""
    def largest(sizes, *_):
        return sizes[-1]
    for plan in (hashgrid.encode_plan, hashgrid.encode_bwd_plan):
        plan.cache_clear()
    monkeypatch.setattr(hashgrid, "_pick_group", largest)
    try:
        est = budget.encode_bwd_estimate(make_field_config("nerf", "hash"),
                                         torch.float32, 65_536, 132)
        assert est.level_group == 8 and est.verdict == "over-budget"
        errors = [f for f in budget.check() if f.severity == "error"]
    finally:
        for plan in (hashgrid.encode_plan, hashgrid.encode_bwd_plan):
            plan.cache_clear()
    assert errors and all("drifted" in f.message for f in errors)
    assert {f.path.split("[")[0] for f in errors} == {"encode_bwd"}


def test_budget_over_smem_is_an_error():
    est = budget.mlp_estimate(
        make_field_config("nerf", "hash"),
        MLPConfig(in_dim=512, hidden_dim=128, n_hidden=8, out_dim=3),
        torch.float32, "serve", 1)
    assert est.smem_bytes > budget.MAX_SMEM_BYTES
    assert est.verdict == "over-smem"


@pytest.mark.parametrize("regs,threads,smem,blocks", [
    (61, 128, 0, 8),          # encode_fwd 3-D F=2 f32 G=2: 2048 regs a warp
    (156, 128, 0, 3),         # encode_fwd 3-D F=2 bf16 G=8: 5120 a warp
    (127, 512, 131_072, 1),   # field_fwd at nerf's density MLP
    (213, 256, 118_784, 1),   # mlp_fwd<128>: 6912 a warp, 2 a sub-partition
    (32, 256, 0, 8),          # composite_fwd: the thread limit
    (16, 32, 0, 32),          # the block limit
    (32, 128, 100_000, 2),    # shared memory: 101,120 bytes a block
    (136, 32, 0, 12),         # 4352 a warp: 3 a sub-partition, not 15 an SM
    (256, 128, 0, 0),         # over 255 registers
    (32, 128, 232_449, 0),    # over the shared memory a block may use
])
def test_blocks_per_sm_hand_worked(regs, threads, smem, blocks):
    assert budget.blocks_per_sm(regs, threads, smem) == blocks


# ----------------------------------------------------- semantic rules
def test_semantic_rules_pass_on_live_code():
    assert torch_rules.check_bucket_retrace() == []
    assert torch_rules.check_in_place_state() == []


def test_in_place_state_catches_a_rebinding_update(monkeypatch):
    real = optim.adam_update

    def rebinding(grads, state, params, cfg):
        params = optim.tree_map(torch.clone, params)
        return real(grads, state, params, cfg)
    monkeypatch.setattr(optim, "adam_update", rebinding)
    (f,) = torch_rules.check_in_place_state()
    assert f.code == "RT203" and "params/w" in f.message


def test_rule_catalog_complete():
    from repro_torch.analysis import ast_rules  # noqa: F401
    cat = {r["code"] for r in registry.rule_catalog()}
    assert cat == {"RA101", "RA102", "RA104", "RA105", "RT201", "RT202",
                   "RT203"}


# ------------------------------------------------------------ reporting
def test_json_report_matches_schema():
    fs = run_ast(FIX / "bad_torch_sync.py") + budget.check()
    rep = registry.report(fs, n_files=1)
    schema = export.load_schema(SCHEMA)
    export.validate(rep, schema)
    export.validate(json.loads(json.dumps(rep)), schema)
    assert rep["summary"]["errors"] == 14
    assert rep["summary"]["warnings"] == 6


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={"PYTHONPATH": str(REPO / "src"),
             "PATH": "/usr/bin:/bin:/usr/local/bin"})


@pytest.mark.parametrize("fixture,code", [("bad_torch_sync.py", "RA101"),
                                          ("bad_tensor_branch.py", "RA102")])
def test_cli_exits_1_on_a_bad_fixture(tmp_path, fixture, code):
    out = tmp_path / "report.json"
    proc = _cli(str(FIX / fixture), "--no-semantic", "--json-out", str(out))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    rep = json.loads(out.read_text())
    assert rep["summary"]["errors"] >= 1
    assert {f["code"] for f in rep["findings"]} == {code}


def test_cli_exits_0_on_the_port(tmp_path):
    """The gate: the whole package, semantic rules included, with every
    suppression carrying its reason; the report validates."""
    proc = _cli("--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rep = json.loads(proc.stdout)
    export.validate(rep, export.load_schema(SCHEMA))
    assert rep["summary"]["errors"] == 0
    assert rep["summary"]["files"] > 50
    assert all(f["suppress_reason"] for f in rep["findings"]
               if f["suppressed"])
    assert _cli("--list-rules").returncode == 0
    assert _cli("--rules").returncode == 2
