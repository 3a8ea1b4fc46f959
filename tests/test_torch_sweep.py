"""The port's sweep tool (``esrecsys_tpu_torch/tools/sweep.py``) against the
JAX package's: the same spec and target give the same runs in grid,
random and bayes sweeps (``tests/test_tools.py``'s quadratic); the port's
YAML reader agrees with ``yaml.safe_load`` on the sweep specs' subset and
raises, naming the line, on anything else; the CLI drives a workload's
``train()`` on the CPU.

Tolerances: none. The sweeps are numpy draws in one order, so their runs
(overrides and metrics) are equal outright; the reader's documents are
equal outright.
"""

import dataclasses
import json

import numpy as np
import pytest
import yaml

from esrecsys_tpu.tools import sweep as jsweep
from esrecsys_tpu_torch.tools import sweep as tsweep


@dataclasses.dataclass(frozen=True)
class Cfg:
    lr: float = 0.0
    flag: int = 0


class Result:
    """The quadratic target of ``tests/test_tools.py``: (lr - 0.3)^2 plus
    0.01 per flag, minimized at lr=0.3, flag 0."""

    def __init__(self, cfg):
        self.last_train_metrics = {}
        self.last_eval_metrics = {
            "eval_loss": (cfg.lr - 0.3) ** 2 + 0.01 * cfg.flag}


SPECS = {
    "grid": dict(method="grid", parameters={
        "lr": {"values": [0.0, 0.3, 0.9]}, "flag": {"values": [0, 1]}},
        max_runs=10),
    "random": dict(method="random", parameters={
        "lr": {"min": 0.0, "max": 1.0}, "flag": {"values": [0, 1]}},
        max_runs=30, seed=0),
    "bayes": dict(method="bayes", parameters={
        "lr": {"min": 0.0, "max": 1.0}, "flag": {"values": [0, 1]}},
        max_runs=16, n_init=5, seed=7),
    "bayes_log": dict(method="bayes", parameters={
        "lr": {"min": 0.001, "max": 1.0,
               "distribution": "log_uniform_values"},
        "flag": {"values": [0, 1]}}, max_runs=8, n_init=3),
    "early_stop": dict(method="grid", parameters={
        "lr": {"values": [0.3, 0.9, 0.8, 0.7, 0.6, 0.5]},
        "flag": {"values": [0]}}, max_runs=6, early_stop_patience=2),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_sweep_runs_equal_the_jax_sweep(name, tmp_path):
    """Grid, random and bayes sweeps: the port's runs equal the JAX
    package's, overrides and metric values, and so do the best runs."""
    kw = SPECS[name]
    common = dict(metric_name="eval_loss", metric_goal="minimize")
    jout = jsweep.run_sweep(jsweep.SweepSpec(**common, **kw), Cfg(), Result,
                            str(tmp_path / "jax"))
    tout = tsweep.run_sweep(tsweep.SweepSpec(**common, **kw), Cfg(), Result,
                            str(tmp_path / "port"))
    assert tout["runs"] == jout["runs"]
    assert tout["best"] == jout["best"]
    saved = json.loads((tmp_path / "port" / "sweep.json").read_text())
    assert saved == json.loads(json.dumps(jout))


def test_sweep_raises_on_a_parameter_the_config_lacks(tmp_path):
    spec = tsweep.SweepSpec(method="grid", metric_name="eval_loss",
                            metric_goal="minimize",
                            parameters={"momentum": {"values": [0.9]}})
    with pytest.raises(ValueError, match="unknown config keys"):
        tsweep.run_sweep(spec, Cfg(), Result, str(tmp_path / "s"))


SWEEP_YAML = """\
# the reference's wandb bayes sweep (pinterest/sweep.yaml's shape)
program: train_shop_the_look.py
method: bayes
metric:
  name: eval_loss
  goal: minimize
parameters:
  learning_rate:
    min: 0.00001
    max: 0.1
    distribution: log_uniform_values
  regularization:
    min: 0.0
    max: 1.0
  output_size:
    values:
      - 32
      - 64
      - 96
max_runs: 12
n_init: 4
"""

FLOW_AND_COMMENTS = """\
method: grid   # exhaustive
parameters:
  # a flow list, quoted items and a nested list
  lr:
    values: [0.001, 0.01, 0.1]   # trailing comment
  tag:
    values: ['a # not a comment', "b: c", plain words, -7, +3, .5]
  nested:
    values: [[1, 2], [], [true, ~]]
  none:
runs:
- name: first
  seed: 1
- - 1
  - 2
-
  deep:
    enabled: yes
"""

DOCS = {"sweep_yaml": SWEEP_YAML, "flow_and_comments": FLOW_AND_COMMENTS}


@pytest.mark.parametrize("name", sorted(DOCS))
def test_yaml_reader_agrees_with_safe_load(name):
    assert tsweep.load_yaml(DOCS[name]) == yaml.safe_load(DOCS[name])


def test_yaml_floats_follow_yaml_1_2():
    """``1e-5`` is a float to the port's reader (YAML 1.2) and a string to
    ``safe_load`` (YAML 1.1); a spec's bounds go through ``float`` in both
    packages, so the runs agree."""
    assert tsweep.load_yaml("min: 1e-5\nmax: -2.5E+3") == {
        "min": 1e-5, "max": -2500.0}
    assert yaml.safe_load("min: 1e-5") == {"min": "1e-5"}


BAD = {
    "anchor": ("base: &b 1\nother: *b\n", 1),
    "alias": ("a: 1\nb: *a\n", 2),
    "tag": ("a: !!float 1\n", 1),
    "block_scalar": ("a: |\n  text\n", 1),
    "flow_mapping": ("a: {b: 1}\n", 1),
    "duplicate_key": ("a: 1\nb: 2\na: 3\n", 3),
    "multiline_flow": ("a: [1,\n  2]\n", 1),
    "document_marker": ("---\na: 1\n", 1),
    "tab": ("a:\n\tb: 1\n", 2),
    "bad_indent": ("a:\n    b: 1\n  c: 2\n", 3),
    "octal": ("a: 0755\n", 1),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_yaml_reader_raises_naming_the_line(name):
    text, line = BAD[name]
    with pytest.raises(tsweep.YamlError, match=f"^line {line}:"):
        tsweep.load_yaml(text)


def test_spec_files_give_the_jax_runs(tmp_path):
    """A YAML spec with a ``1e-5`` bound and its JSON twin, loaded by each
    package's ``SweepSpec.load``, give one run sequence."""
    text = SWEEP_YAML.replace("0.00001", "1e-5").replace(
        "learning_rate", "lr").replace("regularization", "flag").replace(
        "output_size", "size")
    (tmp_path / "spec.yaml").write_text(text)
    (tmp_path / "spec.json").write_text(json.dumps(yaml.safe_load(text)))

    @dataclasses.dataclass(frozen=True)
    class Wide:
        lr: float = 0.0
        flag: float = 0.0
        size: int = 0

    def target(cfg):
        r = Result(Cfg())
        r.last_eval_metrics = {"eval_loss": (np.log10(cfg.lr) + 3) ** 2
                               + cfg.flag + cfg.size / 100}
        return r

    runs = []
    for mod, name in ((jsweep, "spec.yaml"), (tsweep, "spec.yaml"),
                      (tsweep, "spec.json")):
        spec = mod.SweepSpec.load(str(tmp_path / name))
        runs.append(mod.run_sweep(spec, Wide(), target,
                                  str(tmp_path / f"o{len(runs)}"))["runs"])
    assert len(runs[0]) == 12
    assert runs[1] == runs[0] and runs[2] == runs[0]


def test_sweep_cli_drives_glove_train(tmp_path):
    """``python -m esrecsys_tpu_torch.tools.sweep`` on the CPU: a spec file
    and GloVe flags in, each run trained in its own work_dir, the ranked
    sweep.json out."""
    from esrecsys_tpu_torch.data import recordio
    from esrecsys_tpu_torch.data.protos import CooccurrenceRow
    from esrecsys_tpu_torch.data.vocab import VocabEntry, Vocabulary

    rng = np.random.default_rng(0)
    shards = tmp_path / "cooc"
    shards.mkdir()
    rows = [CooccurrenceRow(index=int(rng.integers(1, 20)),
                            other_index=[int(rng.integers(1, 20))],
                            count=[float(rng.random() + 0.1)])
            for _ in range(64)]
    recordio.write_protos(str(shards / "part-00000.bz2"), rows)
    Vocabulary([VocabEntry(token=f"t{i}", frequency=50 - i)
                for i in range(20)]).save(str(tmp_path / "dict.json"))
    (tmp_path / "spec.yaml").write_text(
        "method: grid\nmetric:\n  name: eval_loss\n  goal: minimize\n"
        "parameters:\n  learning_rate:\n    values: [0.001, 0.01]\n")
    out_dir = tmp_path / "sweep_out"
    result = tsweep.main([
        "--spec", str(tmp_path / "spec.yaml"), "--workload", "glove",
        "--out_dir", str(out_dir), "--device", "cpu",
        "--train_pattern", str(shards / "part-*.bz2"),
        "--token_dictionary", str(tmp_path / "dict.json"),
        "--work_dir", str(tmp_path / "base"),
        "--feature_size", "4", "--batch_size", "8",
        "--steps_per_epoch", "3", "--num_epochs", "1",
        "--eval_steps", "1", "--shuffle_buffer_size", "0", "--terms", "",
    ])
    saved = json.loads((out_dir / "sweep.json").read_text())
    assert len(saved["runs"]) == 2
    assert saved["best"]["eval_loss"] == min(r["eval_loss"]
                                             for r in saved["runs"])
    assert result["best"]["overrides"]["learning_rate"] in (1e-3, 1e-2)
    assert (out_dir / "run000" / "metrics.jsonl").exists()
