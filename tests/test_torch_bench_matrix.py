"""The port's registry-driven scenario matrix (``repro_torch.bench.
scenarios`` + ``run``), the mirror of the runner tests of
``tests/test_scenarios.py``:

  (a) every registered app x backend pair appears in the enumerated
      matrix exactly once per supporting bench (and at least once
      overall — the kernels bench spans the full wildcard product);
  (b) cells that cannot run carry a non-empty skip reason, and the
      registry's capability introspection explains *why*;
  (c) ``--list`` is deterministic and byte-stable across two runs,
      honours its filters, and unknown ``--only``/``--cell``/
      ``--backend`` names exit non-zero listing what IS registered; an
      explicitly requested cell that cannot run fails;
  (d) the runner writes the cell's artifact and ``matrix.json`` where it
      is told, and ``docs/matrix_torch.md`` is fresh;
  (e) the port's matrix is the JAX package's, cell for cell and skip
      reason for skip reason, with ``pallas`` named ``cuda``.  One
      difference is allowed, and named: off a CUDA card the kernels
      bench's two ``cuda`` cells skip, with a reason (the JAX package
      runs those cells in Pallas interpret mode on any host).
"""

import json
import os
import subprocess
import sys

import pytest

from torch_bench_reference import REPO
from benchmarks import scenarios as RS
from repro_torch.bench import run as harness
from repro_torch.bench import scenarios as S
from repro_torch.bench.scenarios import Cell

# the one allowed difference from the JAX package's matrix: the cells
# that launch kernels, skipped on a host with no CUDA card
CARD_ONLY = ("kernels/fleet-cuda", "kernels/wami-cuda")
NO_CARD_REASON = ("no CUDA device on this host (the cuda kernels cell "
                  "launches every kernel on the card)")


def _cli(*argv, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(REPO, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "repro_torch.bench.run",
                           *argv], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)


# ----------------------------------------------------------------------
# (a) the matrix covers every registered pair, exactly once per bench
# ----------------------------------------------------------------------
def test_every_registered_pair_once_per_supporting_bench():
    from repro_torch.core.registry import list_apps, list_backends
    cells = S.enumerate_matrix()
    mods = S.bench_modules()
    app_names = [a.name for a in list_apps()]
    backend_names = [b.name for b in list_backends()]
    assert (app_names, backend_names) == (["fleet", "wami"],
                                          ["analytical", "cuda"])
    for bench, mod in mods.items():
        spec = mod.SCENARIOS
        if "pairs" in spec:
            continue
        apps = app_names if spec["apps"] == "*" else list(spec["apps"])
        bks = (backend_names if spec["backends"] == "*"
               else list(spec["backends"]))
        for a in apps:
            for b in bks:
                hits = [sc for sc in cells
                        if sc.cell == Cell(bench, a, b, "")]
                assert len(hits) == 1, (bench, a, b, hits)
    for a in app_names:
        for b in backend_names:
            assert any(sc.cell.app == a and sc.cell.backend == b
                       for sc in cells), (a, b)


def test_matrix_enumeration_is_deterministic_in_process():
    first = S.enumerate_matrix()
    second = S.enumerate_matrix()
    assert first == second
    ids = [sc.cell.id for sc in first]
    assert len(ids) == len(set(ids)), "duplicate cell ids"


# ----------------------------------------------------------------------
# (b) unsupported cells carry a reason; the registry explains why
# ----------------------------------------------------------------------
def _toy_app():
    from repro_torch.core.hlsim import HLSTool
    from repro_torch.core.knobs import KnobSpace
    from repro_torch.core.registry import App
    from repro_torch.core.tmg import pipeline_tmg
    return App(
        name="toy-scenarios-test",
        description="two-stage toy without a measured surface",
        tmg=lambda: pipeline_tmg(["a", "b"]),
        knob_spaces=lambda **_: {n: KnobSpace(clock_ns=1.0, max_ports=2,
                                              max_unrolls=4)
                                 for n in ("a", "b")},
        analytical=lambda: HLSTool({}),
    )


def test_unsupported_cells_carry_skip_reason():
    from repro_torch.core.registry import _APPS, get_backend, register_app
    try:
        register_app(_toy_app())
        toy_cells = [sc for sc in S.enumerate_matrix()
                     if sc.cell.app == "toy-scenarios-test"]
        # the wildcard kernels bench must enumerate the new app...
        assert {sc.cell.bench for sc in toy_cells} >= {"kernels"}
        # ...and every cell it cannot run is skipped WITH a reason
        for sc in toy_cells:
            assert not sc.runnable, sc
            assert sc.skip_reason and sc.skip_reason.strip(), sc
        reason = get_backend("cuda").skip_reason(_toy_app())
        assert reason and "kernel specs" in reason
        assert get_backend("analytical").skip_reason(_toy_app()) is None
    finally:
        _APPS.pop("toy-scenarios-test", None)


def test_every_skip_in_the_real_matrix_is_explained():
    for present in (True, False):
        with S.assume_card(present):
            for sc in S.enumerate_matrix():
                if not sc.runnable:
                    assert sc.skip_reason and sc.skip_reason.strip(), sc


def test_app_describe_carries_capability_block():
    from repro_torch.core.registry import get_app, get_backend, list_apps
    cuda = get_backend("cuda")
    assert cuda.measured is True
    assert cuda.skip_reason(get_app("wami")) is None
    assert cuda.supported_tiles(get_app("wami")) == (64, 128, 256)
    wami = [a for a in list_apps() if a.name == "wami"][0].describe()
    assert wami["measured"] and wami["plm_planner"]
    keys = {(r["tile"], r["device_kind"]) for r in wami["recordings"]}
    assert keys == {(t, "NVIDIA H100 80GB HBM3") for t in (64, 128, 256)}


# ----------------------------------------------------------------------
# (c) --list is byte-stable; unknown names error out loudly
# ----------------------------------------------------------------------
def test_list_is_deterministic_and_byte_stable(capsys):
    """``--list`` in a fresh process prints what it prints in this one."""
    r1 = _cli("--list")
    assert r1.returncode == 0, r1.stderr
    capsys.readouterr()
    assert harness.main(["--list"]) == 0
    assert r1.stdout == capsys.readouterr().out
    lines = r1.stdout.splitlines()
    assert lines[0] == "cell,status,reason"
    assert any(line.startswith("fig10/wami-cuda-share_plm,run")
               for line in lines)
    assert lines[-1].endswith("0 unexplained")
    assert "jax" not in r1.stderr


def test_unknown_names_exit_nonzero_and_list_valid(capsys):
    assert harness.main(["--only", "nonesuch"]) != 0
    err = capsys.readouterr().err
    assert "nonesuch" in err and "fig10" in err
    assert harness.main(["--cell", "bogus/none-such"]) != 0
    assert "fig4/wami-analytical" in capsys.readouterr().err
    assert harness.main(["--backend", "verilog"]) != 0
    err = capsys.readouterr().err
    assert "analytical" in err and "cuda" in err
    assert harness.main(["--app", "nope"]) != 0
    assert "wami" in capsys.readouterr().err


def test_list_honours_filters(capsys):
    assert harness.main(["--list", "--only", "fig10"]) == 0
    lines = capsys.readouterr().out.splitlines()
    body = [ln for ln in lines[1:] if not ln.startswith("#")]
    assert len(body) == 8 and all(ln.startswith("fig10/") for ln in body)
    assert harness.main(["--list", "--app", "fleet", "--backend",
                         "cuda"]) == 0
    body = [ln for ln in capsys.readouterr().out.splitlines()[1:]
            if not ln.startswith("#")]
    assert [ln.split(",")[0] for ln in body] == ["kernels/fleet-cuda",
                                                 "fleet/fleet-cuda"]


def test_explicitly_requested_unrunnable_cell_fails(tmp_path):
    from repro_torch.core.registry import _APPS, register_app
    try:
        register_app(_toy_app())
        # the wildcard kernels bench enumerates the toy app; naming its
        # (skipped) cell explicitly must exit non-zero, not silently 0
        rc = harness.main(["--cell",
                           "kernels/toy-scenarios-test-analytical",
                           "--out-dir", str(tmp_path)])
        assert rc != 0
    finally:
        _APPS.pop("toy-scenarios-test", None)
    # so does a cell that needs the card, named on a host without one
    with S.assume_card(False):
        assert harness.main(["--cell", "kernels/wami-cuda", "--out-dir",
                             str(tmp_path)]) != 0
    doc = json.loads((tmp_path / "matrix.json").read_text())
    by_id = {c["id"]: c for c in doc["cells"]}
    assert by_id["kernels/wami-cuda"]["status"] == "skip"
    assert by_id["kernels/wami-cuda"]["reason"] == NO_CARD_REASON


# ----------------------------------------------------------------------
# (d) artifacts land where the runner is told; the docs are fresh
# ----------------------------------------------------------------------
def test_runner_writes_cell_artifact_and_matrix_json(tmp_path):
    rc = harness.main(["--cell", "autoshard/zoo-analytical",
                       "--out-dir", str(tmp_path)])
    assert rc == 0
    assert (tmp_path / "autoshard" / "zoo-analytical.csv").exists()
    doc = json.loads((tmp_path / "matrix.json").read_text())
    assert doc["generated_by"] == "python -m repro_torch.bench.run"
    by_id = {c["id"]: c for c in doc["cells"]}
    ran = by_id["autoshard/zoo-analytical"]
    assert ran["status"] == "run" and ran["seconds"] > 0
    assert ran["artifact"] == os.path.join("autoshard",
                                           "zoo-analytical.csv")
    assert ran["summary"]                       # the stdout csv rows
    others = [c for c in doc["cells"] if c["id"] != ran["id"]]
    assert others and all(c["status"] == "filtered" for c in others)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["autoshard",
                                                          "matrix.json"]


def test_default_outputs_are_the_port_s_own():
    assert harness.OUT_DIR == os.path.join(REPO, "artifacts", "bench_torch")
    assert harness.DOCS_MD == os.path.join(REPO, "docs", "matrix_torch.md")
    assert Cell("fig10", "wami", "cuda", "tiles").artifact == os.path.join(
        "fig10", "wami-cuda-tiles.csv")


def test_matrix_md_is_fresh():
    """docs/matrix_torch.md must match a regeneration from the live
    registry; it describes the matrix as a host with a card runs it,
    whatever host writes it."""
    want = S.render_matrix_md()
    with open(os.path.join(REPO, "docs", "matrix_torch.md")) as f:
        got = f.read()
    assert got == want, ("docs/matrix_torch.md is stale — regenerate with "
                         "`python -m repro_torch.bench.run --emit-docs`")
    for cid in CARD_ONLY:
        assert f"| `{cid}` | run |  | skip: {NO_CARD_REASON} |" in got


def test_emit_docs_writes_where_it_is_told(tmp_path, capsys):
    out = tmp_path / "m.md"
    assert harness.main(["--emit-docs", str(out)]) == 0
    assert out.read_text() == S.render_matrix_md()


# ----------------------------------------------------------------------
# (e) the JAX package's matrix, with pallas named cuda
# ----------------------------------------------------------------------
def _ref_list():
    return [ln.replace("pallas", "cuda")
            for ln in RS.render_list(RS.enumerate_matrix()).splitlines()]


def test_matrix_on_a_card_is_the_reference_s():
    with S.assume_card(True):
        got = S.render_list(S.enumerate_matrix()).splitlines()
    assert got == _ref_list()
    assert got[-1] == ("# matrix: 24 cells, 23 runnable, 1 skipped, "
                       "0 unexplained")


def test_matrix_off_the_card_differs_only_by_the_named_skip():
    with S.assume_card(False):
        got = S.render_list(S.enumerate_matrix()).splitlines()
    want = _ref_list()
    assert len(got) == len(want) == 26
    differ = [(g, w) for g, w in zip(got, want) if g != w]
    assert [g for g, _ in differ[:-1]] == [f"{cid},skip,{NO_CARD_REASON}"
                                           for cid in CARD_ONLY]
    assert [w for _, w in differ[:-1]] == [f"{cid},run," for cid in CARD_ONLY]
    assert differ[-1] == ("# matrix: 24 cells, 21 runnable, 3 skipped, "
                          "0 unexplained", want[-1])


@pytest.mark.parametrize("bench", sorted(S.BENCH_MODULES))
def test_bench_tables_are_the_reference_s(bench):
    """Each bench spans the reference's axes (``pallas`` named ``cuda``)."""
    port = S.bench_modules()[bench].SCENARIOS
    ref = RS.bench_modules()[bench].SCENARIOS
    assert list(S.BENCH_MODULES) == list(RS.BENCH_MODULES)
    assert S.BENCH_MODULES[bench] == RS.BENCH_MODULES[bench]
    assert json.dumps(port, sort_keys=True) == json.dumps(
        ref, sort_keys=True).replace("pallas", "cuda")
