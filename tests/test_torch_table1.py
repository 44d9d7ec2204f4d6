"""Port parity for the Table-1 harness: the bench schema and comparator
(``repro_torch.bench``) against ``repro.bench``, the baseline-sparsity
probe (``repro_torch.train.classifier.measure_baseline_sparsity``) against
``benchmarks/harness.py``, and the Table-1 rows and gates
(``repro_torch.train.table1``) against ``benchmarks/table1_sparsity.py``.

The comparator's verdicts are functions of the records alone, so both
sides get the same records (through each side's ``from_dict``) and must
return the same findings, in order. The baseline sparsity is a mean of
fractions of exact zeros: the same parameters and batches give the same
zeros on both sides (ReLU masks of pre-activations that agree to rounding,
and no exact zero a BatchNorm's dense gradient could round into), and the
mean over layers and steps is taken the same way: rel 1e-6.

The reference's CIFAR rows that the card's Table-1 run is held to are
data (``src/repro_torch/bench/baselines/table1_cifar_reference.json``,
made by ``tests/table1_cifar_rows.py``); the last two tests check that
file against ``chip_smoke.py``'s seeds and the script's merge of rows.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import bench as jbench  # noqa: E402
from repro.configs import paper_models as jpm  # noqa: E402
from repro_torch import bench  # noqa: E402
from repro_torch.configs import paper_models as pm  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.cnn import CNN  # noqa: E402
from repro_torch.train import classifier, table1  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BASELINE = ROOT / "benchmarks" / "baselines" / "BENCH_table1_sparsity.json"


def _record(name="table1/lenet5", value=100.0, acc=97.0, sparsity=90.0,
            gates=None, derived=None):
    return {"name": name, "value": value, "unit": "us/step",
            "derived": derived or {"acc": acc, "sparsity": sparsity},
            "gates": gates or {"acc": {"abs": 2.0, "direction": "low"},
                               "sparsity": {"rel": 0.05, "direction": "low"}},
            "context": {"model": "lenet5"}}


def _run_dict(records, quick=True):
    return {"schema_version": 1, "suite": "table1_sparsity", "git_sha": "abc1234",
            "platform": "cpu", "quick": quick, "results": records}


# (current records, baseline records or None, current quick, baseline quick)
SCENARIOS = {
    "no-baseline": ([_record()], None, True, True),
    "new": ([_record(), _record(name="table1/resnet18", acc=80.0)],
            [_record()], True, True),
    "within-band": ([_record(acc=95.5, sparsity=86.0)],
                    [_record(acc=97.0, sparsity=90.0)], True, True),
    "regression": ([_record(acc=90.0)], [_record(acc=97.0)], True, True),
    "missing": ([_record()], [_record(), _record(name="table1/mlp")], True, True),
    "timing-only": ([_record(value=5000.0)], [_record(value=100.0)], True, True),
    "improvement": ([_record(acc=99.9, sparsity=95.0)],
                    [_record(acc=90.0, sparsity=85.0)], True, True),
    "high-gate": ([_record(derived={"w": 0.09},
                           gates={"w": {"rel": 0.1, "direction": "high"}})],
                  [_record(derived={"w": 0.06},
                           gates={"w": {"rel": 0.1, "direction": "high"}})],
                  True, True),
    "exact": ([_record(derived={"p": 11.0}, gates={"p": {"abs": 0.0}})],
              [_record(derived={"p": 10.0}, gates={"p": {"abs": 0.0}})],
              True, True),
    "ghost-metric": ([_record(gates={"ghost": {"abs": 1.0}})],
                     [_record(gates={"ghost": {"abs": 1.0}})], True, True),
    "mode-mismatch": ([_record(acc=10.0)], [_record(acc=97.0)], False, True),
    "current-gates-rule": (
        [_record(acc=90.0, gates={"acc": {"abs": 2.0, "direction": "low"}})],
        [_record(acc=97.0, gates={"acc": {"abs": 50.0, "direction": "low"}})],
        True, True),
}


def _findings(report):
    return [(f.bench, f.metric, f.status, f.baseline, f.current, f.band)
            for f in report.findings]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_comparator_verdicts_match_reference(scenario):
    cur, base, cur_quick, base_quick = SCENARIOS[scenario]
    cur_d = _run_dict(cur, cur_quick)
    base_d = None if base is None else _run_dict(base, base_quick)
    got = bench.compare_runs(bench.SuiteRun.from_dict(cur_d),
                             None if base_d is None else bench.SuiteRun.from_dict(base_d))
    want = jbench.compare_runs(jbench.SuiteRun.from_dict(cur_d),
                               None if base_d is None else jbench.SuiteRun.from_dict(base_d))
    assert got.ok == want.ok
    np.testing.assert_equal(_findings(got), _findings(want))
    assert got.render(verbose=True) == want.render(verbose=True)


def test_schema_json_round_trip():
    run = bench.SuiteRun.from_dict(_run_dict([_record(), _record(name="table1/mlp")]))
    again = bench.SuiteRun.from_dict(json.loads(json.dumps(run.to_dict())))
    assert again == run
    assert again.by_name()["table1/lenet5"].gates["acc"] == bench.Gate(
        abs=2.0, direction="low")
    r = run.results[0]
    assert bench.BenchResult.from_dict(json.loads(json.dumps(r.to_dict()))) == r
    assert r.derived_str() == jbench.BenchResult.from_dict(
        _record()).derived_str()


def test_schema_reads_the_reference_baseline_as_data():
    d = json.loads(BASELINE.read_text())
    run = bench.SuiteRun.from_dict(d)
    ref = jbench.SuiteRun.from_dict(d)
    assert [r.to_dict() for r in run.results] == [r.to_dict() for r in ref.results]
    assert (run.suite, run.quick, run.git_sha) == (ref.suite, ref.quick, ref.git_sha)
    out = run.to_dict()
    assert "torch_version" in out and "jax_version" not in out
    assert bench.compare_runs(run, run).ok


def test_provenance_stamped():
    run = bench.make_suite_run("table1_sparsity", [], device="cpu")
    assert run.torch_version == torch.__version__
    assert run.platform == "cpu"


def _reference_params_loaded(monkeypatch, jmodel, seed=0):
    """Make the port's CNN start from the reference's initial parameters."""
    params, _ = jmodel.init(jax.random.PRNGKey(seed))
    state = params_from_jax({n: np.asarray(a) for n, a in params.items()})

    def loaded(cfg, *, seed=0, device=None):
        net = CNN(cfg, seed=seed, device=device)
        net.load_state_dict(state)
        return net

    monkeypatch.setattr(classifier, "CNN", loaded)


def test_measure_baseline_sparsity_matches_reference(monkeypatch):
    from benchmarks.harness import measure_baseline_sparsity as j_measure

    jm = jpm.lenet5()
    want = j_measure(jm, steps=2, batch=4)
    _reference_params_loaded(monkeypatch, jm)
    got = classifier.measure_baseline_sparsity(pm.lenet5(), steps=2, batch=4,
                                               device="cpu")
    assert 0.0 < got < 100.0
    assert got == pytest.approx(want, rel=1e-6)


def _fake_rows():
    rows = []
    for i, name in enumerate(table1.FULL_MODELS):
        row = {"model": name, "baseline_acc": 100.0 - i,
               "baseline_sparsity": 30.0 + i, "us_per_step_baseline": 10.0 + i}
        for j, m in enumerate(("dithered", "int8+dith")):
            row[f"{m}_acc"] = 99.0 - i - j
            row[f"{m}_sparsity"] = 90.0 + i + j
            row[f"{m}_bits"] = 6.0 + j
            row[f"us_per_step_{m}"] = 20.0 + i + j
        rows.append(row)
    return rows


def test_results_match_reference_bench(monkeypatch):
    """The same rows give the reference's BenchResults: names, values,
    derived metrics and gates."""
    import benchmarks.table1_sparsity as jt

    rows = _fake_rows()
    monkeypatch.setattr(jt, "run", lambda quick=True: rows)
    want = [r.to_dict() for r in jt.bench(quick=False)]
    assert [r.to_dict() for r in table1.results(rows)] == want
    assert table1.QUICK_MODELS == jt.QUICK_MODELS
    assert table1.FULL_MODELS == jt.FULL_MODELS
    for name in table1.FULL_MODELS:
        jcfg, cfg = jt._model(name).cfg, table1._model(name)
        assert (cfg.name, cfg.arch, cfg.n_classes, cfg.in_channels, cfg.img_size,
                cfg.hidden) == (jcfg.name, jcfg.arch, jcfg.n_classes,
                                jcfg.in_channels, jcfg.img_size, jcfg.hidden)


def test_check_gates_the_baseline_rows():
    """The full run's rows that the quick baseline names are gated; the
    others are not compared."""
    base = bench.SuiteRun.from_dict(json.loads(BASELINE.read_text()))
    rows = []
    for r in base.results:
        d = r.derived
        rows.append({"model": r.name.split("/", 1)[1],
                     "baseline_acc": d["baseline_acc"],
                     "baseline_sparsity": d["baseline_sparsity"],
                     "us_per_step_baseline": d["us_per_step_baseline"],
                     "dithered_acc": d["dithered_acc"],
                     "dithered_sparsity": d["dithered_sparsity"],
                     "dithered_bits": d["dithered_bits"],
                     "us_per_step_dithered": r.value,
                     "int8+dith_acc": d["int8_dith_acc"],
                     "int8+dith_sparsity": d["int8_dith_sparsity"],
                     "int8+dith_bits": d["dithered_bits"],
                     "us_per_step_int8+dith": r.value})
    extra = dict(rows[0], model="resnet18-c10", dithered_acc=0.0)
    report = table1.check(table1.results(rows + [extra]), base)
    assert report.ok, report.render(verbose=True)
    assert all(f.bench != "table1/resnet18-c10" for f in report.findings)
    rows[2] = dict(rows[2], dithered_sparsity=rows[2]["dithered_sparsity"] - 9.0)
    report = table1.check(table1.results(rows), base)
    assert [(f.bench, f.metric) for f in report.regressions] == [
        ("table1/lenet5", "dithered_sparsity")]


def test_run_and_cli(capsys):
    """Two steps of the quick rows on the CPU: the reference's columns, and
    the CLI's one JSON line a row."""
    rows = table1.run(steps=2, device="cpu")
    assert [r["model"] for r in rows] == list(table1.QUICK_MODELS)
    row = rows[1]
    assert list(row) == ["model", "baseline_acc", "baseline_sparsity",
                         "us_per_step_baseline", "dithered_acc",
                         "dithered_sparsity", "dithered_bits",
                         "us_per_step_dithered", "int8+dith_acc",
                         "int8+dith_sparsity", "int8+dith_bits",
                         "us_per_step_int8+dith"]
    assert all(np.isfinite(v) for k, v in row.items() if k != "model")
    assert 0 < row["dithered_sparsity"] <= 100 and row["dithered_bits"] <= 8
    assert table1.main(["--steps", "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line)["model"] for line in lines] == list(table1.QUICK_MODELS)


CIFAR_REFERENCE = (ROOT / "src" / "repro_torch" / "bench" / "baselines"
                   / "table1_cifar_reference.json")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cifar_reference_rows_cover_the_smoke_seeds():
    """The reference's VGG11 rows that chip_smoke.py holds the card's mean
    accuracies to: one a seed, as many seeds as it expects, each at the
    reference's recipe, with the row's columns and values in range."""
    smoke = _load(ROOT / "chip_smoke.py", "chip_smoke_consts")
    data = json.loads(CIFAR_REFERENCE.read_text())
    assert data["platform"] == "cpu"
    rows = [r for r in data["rows"] if r["model"] == "vgg11-c10"]
    assert [r["seed"] for r in rows] == list(range(smoke.TABLE1_REFERENCE_SEEDS))
    assert Path(ROOT / smoke.TABLE1_REFERENCE) == CIFAR_REFERENCE
    for r in rows:
        assert (r["system"], r["steps"]) == ("reference", 50)
        for m in ("baseline", "dithered", "int8+dith"):
            assert 0 <= r[f"{m}_acc"] <= 100
        assert 0 < r["dithered_sparsity"] <= 100 and r["dithered_bits"] <= 8


def test_cifar_rows_script_merges_reference_rows(tmp_path):
    """tests/table1_cifar_rows.py --rows ... --out: the reference's rows of
    the chosen models and seeds merge into the data file, a new row
    replacing the old one of its model and seed; the port's rows stay out."""
    script = _load(ROOT / "tests" / "table1_cifar_rows.py", "table1_cifar_rows")

    def row(system, seed, acc, model="vgg11-c10"):
        return {"system": system, "seed": seed, "steps": 50, "model": model,
                "dithered_acc": acc}

    lines = tmp_path / "rows.jsonl"
    lines.write_text("".join(json.dumps(r) + "\n" for r in [
        row("reference", 0, 40.0), row("reference", 1, 30.0),
        row("port", 0, 20.0), row("reference", 2, 50.0),
        row("reference", 0, 10.0, model="alexnet-c10")]))
    out = tmp_path / "ref.json"
    out.write_text(json.dumps({"rows": [row("reference", 1, 99.0),
                                        row("reference", 5, 60.0)]}))
    assert script.main(["--system", "reference", "--models", "vgg11-c10",
                        "--seeds", "0", "1", "--rows", str(lines),
                        "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    assert [(r["seed"], r["dithered_acc"]) for r in got["rows"]] == [
        (0, 40.0), (1, 30.0), (5, 60.0)]
    assert got["platform"] == "cpu" and "table1_cifar_rows.py" in got["made_by"]
