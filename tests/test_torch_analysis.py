"""The port's tpucheck (tpunet_torch/analysis/): rule fixtures, parity
with tpunet's rules on tpunet's own fixtures, baseline semantics,
suppressions, CLI exit codes, and the tree-is-clean gate.

The port's fixture trees are written into ``tmp_path`` from the strings
below: ``r<N>_bad_*`` cases must each fire their rule, ``r<N>_good_*``
cases must stay clean. tpunet's fixtures under tests/fixtures/tpucheck/
are read, never written: each R4/R5/R6 case is copied with its
``tpunet/`` paths renamed ``tpunet_torch/``, and the port's rule must
give on the copy the (rule, key) set that tpunet's rule gives on the
original. ``test_tree_is_clean_against_baseline`` is the gate itself:
``python -m tpunet_torch.analysis --strict-baseline`` on this repo
exits 0.
"""

import json
import os
import shutil

import pytest

from tpunet.analysis import Project as JaxProject
from tpunet.analysis import rules_by_id as jax_rules_by_id
from tpunet.analysis import run_rules as jax_run_rules
from tpunet_torch.analysis import (ALL_RULES, Project, rules_by_id,
                                   run_rules)
from tpunet_torch.analysis import baseline as baseline_mod
from tpunet_torch.analysis.__main__ import main as tpucheck_main

import _torch_threads  # noqa: F401
from test_torch_obs_history import run_without_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FIXTURES = os.path.join(REPO, "tests", "fixtures", "tpucheck")

# -- the port's fixture trees: {relative path: source} ------------------

_LOADER = '''\
import functools
import os

from tpunet_torch.ops import _build


@functools.lru_cache(maxsize=None)
def _kernel():
    return _build.load("k").tpunet_k


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = _build.load("k2")
    return lib.tpunet_fwd, lib.tpunet_bwd


def reference(x):
    return x
'''

_OP = "tpunet_torch/ops/k.py"

FIXTURES = {
    # R2: the launch rule, one bad and one good tree for each condition.
    "r2_bad_unchecked": {_OP: _LOADER + '''

def op(x):
    _kernel()(x)
    op.launches += 1
    return x
'''},
    "r2_bad_uncounted": {_OP: _LOADER + '''

def op(x):
    err = _kernels()[0](x)
    if err != 0:
        raise RuntimeError(f"op: CUDA error {err}")
    return x
'''},
    "r2_bad_swallowed": {_OP: _LOADER + '''

def op(x):
    try:
        err = _kernel()(x)
        if err != 0:
            raise RuntimeError(f"op: CUDA error {err}")
    except RuntimeError:
        return reference(x)
    op.launches += 1
    return x
'''},
    "r2_bad_env": {_OP: _LOADER + '''

def op(x):
    if os.environ.get("PLAIN_OPS"):
        return reference(x)
    fn = _kernel()
    err = fn(x)
    if err != 0:
        raise RuntimeError(f"op: CUDA error {err}")
    op.launches += 1
    return x
'''},
    "r2_good_checked_counted": {_OP: _LOADER + '''

def op(x):
    fn = _kernel()
    err = fn(x)
    if err != 0:
        raise RuntimeError(f"op: CUDA error {err}")
    op.launches += 1
    return x


def _call(name, wrapper, x):
    err = _kernels()[1](x)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
    wrapper.launches += 1
'''},
    "r2_good_try_reraises": {_OP: _LOADER + '''

def op(x):
    try:
        err = _kernel()(x)
    except OSError as e:
        raise RuntimeError("op: the library is broken") from e
    finally:
        pass
    if err != 0:
        raise RuntimeError(f"op: CUDA error {err}")
    op.launches += 1
    return x
'''},
    "r2_good_env_elsewhere": {_OP: _LOADER + '''

def cache_dir():
    return os.environ.get("CACHE", "build")


def op(x):
    err = _kernel()(x)
    if err != 0:
        raise RuntimeError(f"op: CUDA error {err}")
    op.launches += 1
    return x
''', "tpunet_torch/models/m.py": '''\
from tpunet_torch.ops import _build


def not_an_op(x):
    _build.load("k").tpunet_k(x)
'''},
    # R4: the thread registry.
    "r4_bad_thread": {"tpunet_torch/serve/w.py": '''\
import threading


class Worker:
    def start(self):
        self._t = threading.Thread(target=self._run, name="worker")
        self._t.start()

    def _run(self):
        pass
'''},
    "r4_bad_popen": {"tpunet_torch/router/spawn.py": '''\
import subprocess


def spawn(argv):
    return subprocess.Popen(argv)
'''},
    "r4_good_registered": {"tpunet_torch/serve/w.py": '''\
import threading

from tpunet_torch.obs import flightrec


class Worker:
    def start(self):
        self._h = flightrec.register_thread("worker", stall_after_s=60.0)
        self._t = threading.Thread(target=self._run, name="worker")
        self._t.start()

    def _run(self):
        self._h.beat("busy")
'''},
    "r4_good_allowlisted": {
        "tpunet_torch/elastic/agent.py": '''\
import subprocess


def launch(argv):
    return subprocess.Popen(argv)
''', "tpunet_torch/obs/flightrec/crash.py": '''\
import subprocess


def watcher(argv):
    return subprocess.Popen(argv, stdin=subprocess.PIPE)
''', "tests/test_x.py": '''\
import threading
threading.Thread(target=print).start()
'''},
    # R5: config/CLI/docs drift.
    "r5_bad_missing_flag": {"tpunet_torch/config.py": '''\
from dataclasses import dataclass


@dataclass
class ServeConfig:
    slots: int = 8
    page_tokens: int = 16


def build(p):
    p.add_argument("--slots", type=int)
''', "README.md": "`--slots` and page_tokens.\n"},
    "r5_bad_missing_docs": {"tpunet_torch/config.py": '''\
from dataclasses import dataclass


@dataclass
class RouterConfig:
    probe_interval_s: float = 1.0


def build(p):
    p.add_argument("--probe-interval-s", type=float)
''', "README.md": "nothing about the prober here\n"},
    "r5_bad_docs_only_in_notes": {"tpunet_torch/config.py": '''\
from dataclasses import dataclass


@dataclass
class ObsConfig:
    flightrec_events: int = 1024


def build(p):
    p.add_argument("--flightrec-events", type=int)
''', "README.md": "the flight recorder\n",
        "CHANGES.md": "added `--flightrec-events`\n",
        "ROADMAP.md": "flightrec_events\n"},
    "r5_good_wired": {"tpunet_torch/config.py": '''\
from dataclasses import dataclass, field


@dataclass
class ObsConfig:
    enabled: bool = True
    heartbeat_timeout_s: float = 300.0


@dataclass
class ModelConfig:
    name: str = "mobilenet_v2"
    obs: ObsConfig = field(default_factory=ObsConfig)
''', "tpunet_torch/train/__main__.py": '''\
def build(p):
    p.add_argument("--no-obs", action="store_true")
    p.add_argument("--heartbeat-timeout", type=float)
    p.add_argument("--model")
''', "docs/obs.md": "`--no-obs`, `--heartbeat-timeout`, `--model`.\n"},
    # R6: instrument names against docs/metrics_schema.md.
    "r6_bad_undocumented": {"tpunet_torch/serve/m.py": '''\
def instruments(reg):
    reg.counter("serve_requests_total")
    reg.gauge("serve_secret_gauge")
''', "docs/metrics_schema.md": "- `serve_requests_total`\n"},
    "r6_bad_fstring": {"tpunet_torch/obs/x.py": '''\
def instruments(reg, name):
    reg.counter(f"export_{name}_lost")
''', "docs/metrics_schema.md": "- `export_<name>_dropped`\n"},
    "r6_good_documented": {"tpunet_torch/obs/x.py": '''\
def instruments(reg, name, which):
    reg.counter("serve_requests_total")
    reg.histogram("ttft_p50_s")
    reg.counter(f"export_{name}_dropped")
    reg.gauge(which)
''', "docs/metrics_schema.md":
        "- `serve_requests_total`, `ttft_{p50,p90}_s`\n"
        "- `export_<name>_dropped`\n",
        "scripts/torch_fake.py": "def f(reg):\n    reg.gauge('fake')\n"},
}

BAD_CASES = [
    ("r2_bad_unchecked", "R2", "unchecked:op"),
    ("r2_bad_uncounted", "R2", "uncounted:op"),
    ("r2_bad_swallowed", "R2", "swallowed:op"),
    ("r2_bad_env", "R2", "env:op"),
    ("r4_bad_thread", "R4", "thread:Worker:worker"),
    ("r4_bad_popen", "R4", "process:spawn:anon"),
    ("r5_bad_missing_flag", "R5", "ServeConfig.page_tokens:cli"),
    ("r5_bad_missing_docs", "R5", "RouterConfig.probe_interval_s:docs"),
    ("r5_bad_docs_only_in_notes", "R5", "ObsConfig.flightrec_events:docs"),
    ("r6_bad_undocumented", "R6", "instrument:serve_secret_gauge"),
    ("r6_bad_fstring", "R6", "instrument:export_<...>_lost"),
]

GOOD_CASES = [
    ("r2_good_checked_counted", "R2"),
    ("r2_good_try_reraises", "R2"),
    ("r2_good_env_elsewhere", "R2"),
    ("r4_good_registered", "R4"),
    ("r4_good_allowlisted", "R4"),
    ("r5_good_wired", "R5"),
    ("r6_good_documented", "R6"),
]


def _tree(tmp_path, case):
    root = tmp_path / case
    for rel, text in FIXTURES[case].items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return str(root)


def _run_fixture(tmp_path, case, rule_id):
    roots = ("tpunet_torch", "scripts/torch_*.py", "chip_smoke.py")
    return run_rules(Project(_tree(tmp_path, case), roots),
                     [rules_by_id()[rule_id]])


def test_every_fixture_is_in_a_case():
    named = {c for c, *_ in BAD_CASES} | {c for c, _ in GOOD_CASES}
    assert named == set(FIXTURES)


@pytest.mark.parametrize("case,rule_id,key", BAD_CASES)
def test_bad_fixture_fires(tmp_path, case, rule_id, key):
    findings = _run_fixture(tmp_path, case, rule_id)
    assert findings, f"{case}: no {rule_id} finding"
    assert all(f.rule == rule_id for f in findings)
    assert key in {f.key for f in findings}, [f.render() for f in findings]
    for f in findings:
        assert f.line > 0 and f.path and f.key, f
        assert f.hint, f"finding without a fix hint: {f.render()}"


@pytest.mark.parametrize("case,rule_id", GOOD_CASES)
def test_good_fixture_clean(tmp_path, case, rule_id):
    findings = _run_fixture(tmp_path, case, rule_id)
    assert findings == [], [f.render() for f in findings]


def test_launch_rule_names_only_the_broken_condition(tmp_path):
    """Each bad launch tree breaks one condition and is flagged for that
    one alone, at the kernel call's line."""
    for case, _, key in BAD_CASES[:4]:
        findings = _run_fixture(tmp_path, case, "R2")
        assert [f.key for f in findings] == [key], case
        src = FIXTURES[case][_OP].splitlines()
        assert "_kernel" in src[findings[0].line - 1] \
            or "fn(x)" in src[findings[0].line - 1], case


# -- parity with tpunet's rules on tpunet's fixtures --------------------

JAX_PARITY_CASES = sorted(
    name for name in os.listdir(JAX_FIXTURES)
    if name.startswith(("r4_", "r5_", "r6_")))


def _renamed_copy(src_root, dst_root):
    for dirpath, _, files in os.walk(src_root):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), src_root)
            parts = rel.split(os.sep)
            if parts[0] == "tpunet":
                parts[0] = "tpunet_torch"
            dst = os.path.join(dst_root, *parts)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copyfile(os.path.join(dirpath, name), dst)


@pytest.mark.parametrize("case", JAX_PARITY_CASES)
def test_rule_matches_tpunets_on_its_fixtures(tmp_path, case):
    rule_id = "R" + case[1]
    src = os.path.join(JAX_FIXTURES, case)
    dst = str(tmp_path / case)
    _renamed_copy(src, dst)
    want = {(f.rule, f.key) for f in jax_run_rules(
        JaxProject(src), [jax_rules_by_id()[rule_id]])}
    got = {(f.rule, f.key) for f in run_rules(
        Project(dst), [rules_by_id()[rule_id]])}
    assert got == want
    assert bool(want) == ("_bad_" in case)


# -- suppressions and baseline ------------------------------------------

def test_inline_suppression_is_line_scoped(tmp_path):
    proj = tmp_path / "tpunet_torch"
    proj.mkdir()
    (proj / "w.py").write_text(
        "import threading\n"
        "a = threading.Thread(target=print)  # tpucheck: disable=R4\n"
        "b = threading.Thread(target=print)\n")
    findings = run_rules(Project(str(tmp_path)), [rules_by_id()["R4"]])
    assert len(findings) == 1 and findings[0].line == 3


def test_suppression_wrong_rule_does_not_apply(tmp_path):
    proj = tmp_path / "tpunet_torch"
    proj.mkdir()
    (proj / "w.py").write_text(
        "import threading\n"
        "a = threading.Thread(target=print)  # tpucheck: disable=R2\n")
    findings = run_rules(Project(str(tmp_path)), [rules_by_id()["R4"]])
    assert len(findings) == 1


def test_standalone_suppression_covers_the_next_line(tmp_path):
    root = _tree(tmp_path, "r2_bad_unchecked")
    path = os.path.join(root, _OP)
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace("    _kernel()(x)\n",
                             "    # tpucheck: disable=R2\n"
                             "    _kernel()(x)\n"))
    assert run_rules(Project(root), [rules_by_id()["R2"]]) == []


def test_baseline_roundtrip_and_staleness(tmp_path):
    root = _tree(tmp_path, "r4_bad_thread")
    findings = run_rules(Project(root), [rules_by_id()["R4"]])
    assert findings
    path = str(tmp_path / "baseline.json")

    # write-baseline produces TODO entries the loader refuses...
    todo = baseline_mod.write(path, findings, baseline_mod.Baseline())
    assert todo == len({f.identity() for f in findings})
    with pytest.raises(ValueError, match="TODO"):
        baseline_mod.load(path)

    # ...until a human writes the why; then the findings are accepted.
    with open(path) as f:
        data = json.load(f)
    for e in data["entries"]:
        e["why"] = "fixture: intentionally kept"
    with open(path, "w") as f:
        json.dump(data, f)
    bl = baseline_mod.load(path)
    new, accepted, stale = bl.split(findings)
    assert new == [] and len(accepted) == len(findings) and stale == []

    # a fixed tree sheds the entry: same baseline, no findings -> stale
    new, accepted, stale = bl.split([])
    assert new == [] and accepted == [] and len(stale) >= 1


def test_baseline_rejects_unjustified_entries(tmp_path):
    path = str(tmp_path / "b.json")
    with open(path, "w") as f:
        json.dump({"version": 1, "entries": [
            {"rule": "R2", "path": "x.py", "key": "k"}]}, f)
    with pytest.raises(ValueError, match="why"):
        baseline_mod.load(path)


# -- CLI -----------------------------------------------------------------

def test_cli_exit_codes_in_process(tmp_path):
    bad = _tree(tmp_path, "r4_bad_thread")
    good = _tree(tmp_path, "r4_good_registered")
    assert tpucheck_main(["--root", bad, "--baseline", "none"]) == 1
    assert tpucheck_main(["--root", good, "--baseline", "none"]) == 0
    assert tpucheck_main(["--list-rules"]) == 0
    assert tpucheck_main(["--rules", "R9", "--root", good]) == 2
    assert tpucheck_main(["--rules", "R1", "--root", good]) == 2
    assert tpucheck_main(["--root", str(tmp_path / "missing")]) == 2


def test_cli_strict_baseline_fails_on_a_stale_entry(tmp_path):
    good = _tree(tmp_path, "r4_good_registered")
    path = str(tmp_path / "stale.json")
    with open(path, "w") as f:
        json.dump({"version": 1, "entries": [
            {"rule": "R4", "path": "tpunet_torch/serve/w.py",
             "key": "thread:Worker:worker", "why": "fixed since"}]}, f)
    assert tpucheck_main(["--root", good, "--baseline", path]) == 0
    assert tpucheck_main(["--root", good, "--baseline", path,
                          "--strict-baseline"]) == 1


def test_cli_json_output(tmp_path, capsys):
    bad = _tree(tmp_path, "r2_bad_env")
    rc = tpucheck_main(["--root", bad, "--baseline", "none", "--json",
                        "--rules", "R2"])
    assert rc == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["findings"] and payload["baselined"] == []
    assert {"rule", "path", "line", "message", "hint", "key"} <= set(
        payload["findings"][0])


def test_cli_module_entry_subprocess_without_jax(tmp_path):
    """``python -m tpunet_torch.analysis`` with jax and tpunet made
    unimportable: exit 1 on a bad tree, 0 on a good one and on this
    repo under --strict-baseline, 2 on a bad rule id."""
    bad = _tree(tmp_path, "r2_bad_uncounted")
    res = run_without_jax("tpunet_torch.analysis",
                          ["--root", bad, "--baseline", "none"])
    assert res.returncode == 1, res.stdout + res.stderr
    assert "[R2]" in res.stdout
    good = _tree(tmp_path, "r2_good_checked_counted")
    res = run_without_jax("tpunet_torch.analysis",
                          ["--root", good, "--baseline", "none"])
    assert res.returncode == 0, res.stdout + res.stderr
    res = run_without_jax("tpunet_torch.analysis",
                          ["--strict-baseline", "--json"])
    assert res.returncode == 0, res.stdout + res.stderr
    assert json.loads(res.stdout)["findings"] == []
    res = run_without_jax("tpunet_torch.analysis", ["--rules", "R3"])
    assert res.returncode == 2


def test_parse_error_is_a_finding(tmp_path):
    proj = tmp_path / "tpunet_torch"
    proj.mkdir()
    (proj / "broken.py").write_text("def oops(:\n")
    findings = run_rules(Project(str(tmp_path)), list(ALL_RULES))
    assert any(f.rule == "PARSE" for f in findings)


def test_default_roots_are_the_ports_code():
    rels = {f.rel for f in Project(REPO).files()}
    assert "chip_smoke.py" in rels
    assert "tpunet_torch/ops/flash.py" in rels
    assert "scripts/torch_dp_check.py" in rels
    assert not [r for r in rels if r.startswith(("tpunet/", "tests/"))]
    assert not [r for r in rels if r.startswith("scripts/")
                and not r.startswith("scripts/torch_")]


# -- the gate -----------------------------------------------------------

def test_tree_is_clean_against_baseline():
    """``python -m tpunet_torch.analysis --strict-baseline`` on this repo
    exits 0: every finding either fixed or baselined with a
    justification, and no stale entry."""
    rc = tpucheck_main(["--root", REPO, "--strict-baseline"])
    assert rc == 0, "tpucheck found unbaselined findings (or stale " \
                    "baseline entries); run python -m tpunet_torch.analysis"


def test_checked_in_baseline_is_justified():
    bl = baseline_mod.load(os.path.join(REPO, "tpunet_torch", "analysis",
                                        "baseline.json"))
    assert bl.entries, "ledger should carry the reviewed exceptions"
    for e in bl.entries:
        assert len(e["why"]) > 20, f"thin justification: {e}"
        assert e["why"] != baseline_mod.TODO_WHY
