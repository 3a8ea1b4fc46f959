"""Local hyperparameter sweeps (counterpart of
``esrecsys_tpu/tools/sweep.py``).

A sweep spec in the reference's wandb shape (``pinterest/sweep.yaml``:
method, metric, parameters with values or min/max) drives repeated runs
of any workload's ``train(cfg)``; each run trains under
``out_dir/runNNN`` and the summary (best run and all runs) lands in
``out_dir/sweep.json``.

Methods: grid, random, bayes. ``bayes`` is a numpy-only Gaussian-process
surrogate (RBF kernel over [0,1]-normalized parameters, log space for
log-distributed ones) with expected improvement over random candidates:
``n_init`` random warm-up runs, then EI-maximizing picks.
``early_stop_patience`` stops any sweep after that many runs without
improvement. The sampling, the GP and the order of every draw are the
reference's, so a spec and a seed give the reference's run sequence bit
for bit.

Spec files are JSON, or YAML read by :func:`load_yaml`, the subset that
sweep specs use (no YAML library is needed).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import math
import os
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from esrecsys_tpu_torch.core import config as config_lib

log = logging.getLogger(__name__)


# ------------------------------------------------------------------ YAML

class YamlError(ValueError):
    """A YAML document outside the subset :func:`load_yaml` reads."""


_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(\.[0-9]+|[0-9][0-9_]*(\.[0-9_]*)?)([eE][-+]?[0-9]+)?$")
_BOOLS = {v: True for v in ("true", "True", "TRUE", "yes", "Yes", "YES",
                            "on", "On", "ON")}
_BOOLS.update({v: False for v in ("false", "False", "FALSE", "no", "No",
                                  "NO", "off", "Off", "OFF")})
_NULLS = ("~", "null", "Null", "NULL")
_SPECIAL_FLOATS = {".inf": math.inf, ".Inf": math.inf, ".INF": math.inf,
                   "+.inf": math.inf, "+.Inf": math.inf, "+.INF": math.inf,
                   "-.inf": -math.inf, "-.Inf": -math.inf,
                   "-.INF": -math.inf, ".nan": math.nan, ".NaN": math.nan,
                   ".NAN": math.nan}
# YAML 1.1 forms a reader would take as numbers or times: refused rather
# than read as strings
_AMBIGUOUS = re.compile(r"[-+]?(0[0-9_]+|0[xob].*|[0-9][0-9_]*(:[0-5]?[0-9])+"
                        r"(\.[0-9_]*)?|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*)$")


def _fail(lineno: int, msg: str):
    raise YamlError(f"line {lineno}: {msg}")


def _plain(text: str, lineno: int) -> Any:
    """A plain (unquoted) scalar: null, bool, int, float or string."""
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if text in _SPECIAL_FLOATS:
        return _SPECIAL_FLOATS[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _AMBIGUOUS.match(text):
        _fail(lineno, f"{text!r} is a YAML 1.1 number or date form this "
                      "reader does not take; quote it")
    if _FLOAT.match(text) and any(c.isdigit() for c in text):
        return float(text.replace("_", ""))
    if text[0] in "&*!|>%@`{}?":
        _fail(lineno, f"{text[0]!r} (anchor, alias, tag, block scalar, "
                      "flow mapping or directive) is outside the subset")
    if ": " in text or text.endswith(":") or " #" in text:
        _fail(lineno, f"plain scalar {text!r} holds ': ' or ' #'; quote it")
    return text


def _quoted(text: str, pos: int, lineno: int) -> Tuple[str, int]:
    """The quoted string starting at ``text[pos]`` and the index past it."""
    q = text[pos]
    out, i = [], pos + 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == '"':
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            esc = text[i + 1:i + 2]
            table = {'"': '"', "\\": "\\", "n": "\n", "t": "\t", "/": "/"}
            if esc not in table:
                _fail(lineno, f"escape \\{esc} is outside the subset")
            out.append(table[esc])
            i += 2
            continue
        out.append(c)
        i += 1
    _fail(lineno, f"unterminated {q}-quoted string")


def _strip_comment(text: str) -> str:
    """``text`` without a trailing ``#`` comment (a ``#`` at the start or
    after whitespace, outside quotes)."""
    i, q = 0, None
    while i < len(text):
        c = text[i]
        if q:
            if c == "\\" and q == '"':
                i += 1
            elif c == q:
                q = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " \t[,:-"):
            q = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _scalar(text: str, lineno: int) -> Any:
    """A value on one line: a quoted or plain scalar, or a flow list."""
    if text.startswith("["):
        val, end = _flow_list(text, 0, lineno)
        if text[end:].strip():
            _fail(lineno, f"text after the flow list: {text[end:]!r}")
        return val
    if text[0] in "'\"":
        val, end = _quoted(text, 0, lineno)
        if text[end:].strip():
            _fail(lineno, f"text after the quoted string: {text[end:]!r}")
        return val
    return _plain(text, lineno)


def _flow_list(text: str, pos: int, lineno: int) -> Tuple[list, int]:
    """The flow list ``[a, b, [c]]`` starting at ``text[pos]``, on one
    line, and the index past it."""
    out, i, expect_item = [], pos + 1, True
    while True:
        while i < len(text) and text[i] == " ":
            i += 1
        if i >= len(text):
            _fail(lineno, "unterminated flow list (flow lists must close on "
                          "their line)")
        c = text[i]
        if c == "]":
            return out, i + 1
        if not expect_item:
            if c != ",":
                _fail(lineno, f"expected ',' or ']' in a flow list at "
                              f"{text[i:]!r}")
            i += 1
            expect_item = True
            continue
        if c == "[":
            val, i = _flow_list(text, i, lineno)
        elif c in "'\"":
            val, i = _quoted(text, i, lineno)
        elif c in "{,":
            _fail(lineno, f"{c!r} in a flow list is outside the subset")
        else:
            j = i
            while j < len(text) and text[j] not in ",]":
                j += 1
            val = _plain(text[i:j].strip(), lineno)
            i = j
        out.append(val)
        expect_item = False


def _split_key(text: str, lineno: int) -> Optional[Tuple[Any, str]]:
    """(key, rest) of a ``key: value`` or ``key:`` entry, None when the
    text holds no mapping key."""
    if text[0] in "'\"":
        key, end = _quoted(text, 0, lineno)
        rest = text[end:]
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    if text.startswith("["):
        return None
    m = re.match(r"([^#:]+?|[^#]*?[^ ]):( |$)", text)
    if m is None:
        return None
    key = m.group(1).strip()
    if key[0] in "&*!?|>-" and key != "-":
        _fail(lineno, f"key {key!r}: anchors, aliases, tags and complex "
                      "keys are outside the subset")
    return _plain(key, lineno), text[m.end():].strip()


def load_yaml(text: str) -> Any:
    """The document in ``text`` (``yaml.safe_load``'s result on the subset
    that wandb sweep specs use): block mappings, block lists (of scalars
    or mappings), one-line flow lists, plain and quoted scalars (null,
    bools, ints, floats, strings) and ``#`` comments. Floats follow YAML
    1.2, so ``1e-5`` is a float (``safe_load`` keeps it a string; a spec's
    ``min`` and ``max`` go through ``float`` either way). Anything else
    (anchors, aliases, tags, block scalars, flow mappings, documents,
    tabs, duplicate keys) raises :class:`YamlError` naming the line."""
    lines = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        body = _strip_comment(raw)
        if not body.strip():
            continue
        indent = len(body) - len(body.lstrip(" "))
        if body[indent:indent + 1] == "\t" or "\t" in body[:indent + 1]:
            _fail(lineno, "tabs in indentation")
        content = body[indent:]
        if content in ("---", "...") or content.startswith(("--- ", "%")):
            _fail(lineno, "document markers and directives are outside the "
                          "subset")
        lines.append([lineno, indent, content])
    if not lines:
        return None
    value, end = _block(lines, 0, lines[0][1])
    if end < len(lines):
        _fail(lines[end][0], "unexpected indentation")
    return value


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _block(lines: list, i: int, indent: int) -> Tuple[Any, int]:
    lineno, ind, content = lines[i]
    if ind != indent:
        _fail(lineno, "unexpected indentation")
    if _is_item(content):
        return _block_list(lines, i, indent)
    if _split_key(content, lineno) is not None:
        return _block_map(lines, i, indent)
    if i + 1 < len(lines) and lines[i + 1][1] >= indent:
        _fail(lines[i + 1][0], "a scalar document spans lines")
    return _scalar(content, lineno), i + 1


def _nested(lines: list, i: int, indent: int, lineno: int,
            allow_same_indent_list: bool) -> Tuple[Any, int]:
    """The value of an entry with nothing after its ``:`` or ``-``: the
    block indented under it (or, after a key, a list at its indent), or
    null."""
    if i < len(lines):
        nxt_ind, nxt = lines[i][1], lines[i][2]
        if nxt_ind > indent:
            return _block(lines, i, nxt_ind)
        if allow_same_indent_list and nxt_ind == indent and _is_item(nxt):
            return _block_list(lines, i, indent)
    return None, i


def _block_map(lines: list, i: int, indent: int) -> Tuple[dict, int]:
    out: Dict[Any, Any] = {}
    while i < len(lines) and lines[i][1] == indent:
        lineno, _, content = lines[i]
        if _is_item(content):
            break
        kv = _split_key(content, lineno)
        if kv is None:
            _fail(lineno, f"expected 'key: value', got {content!r}")
        key, rest = kv
        if key in out:
            _fail(lineno, f"duplicate key {key!r}")
        if rest:
            out[key] = _scalar(rest, lineno)
            i += 1
        else:
            out[key], i = _nested(lines, i + 1, indent, lineno, True)
    if i < len(lines) and lines[i][1] > indent:
        _fail(lines[i][0], "unexpected indentation")
    return out, i


def _block_list(lines: list, i: int, indent: int) -> Tuple[list, int]:
    out: List[Any] = []
    while i < len(lines) and lines[i][1] == indent and _is_item(lines[i][2]):
        lineno, _, content = lines[i]
        rest = content[1:].lstrip(" ")
        if not rest:
            val, i = _nested(lines, i + 1, indent, lineno, False)
        elif _is_item(rest) or _split_key(rest, lineno) is not None:
            # an entry on the dash's line: the block continues at its column
            col = indent + len(content) - len(rest)
            lines[i] = [lineno, col, rest]
            val, i = _block(lines, i, col)
        else:
            val = _scalar(rest, lineno)
            i += 1
        out.append(val)
    if i < len(lines) and lines[i][1] > indent:
        _fail(lines[i][0], "unexpected indentation")
    return out, i


# ----------------------------------------------------------------- specs

@dataclasses.dataclass
class SweepSpec:
    method: str                    # grid | random | bayes
    metric_name: str               # e.g. "eval_loss"
    metric_goal: str               # minimize | maximize
    parameters: Dict[str, dict]    # name -> {values: [...]} | {min, max, [log]}
    max_runs: int = 20
    seed: int = 0
    n_init: int = 5                # bayes: random warmup runs before the GP
    early_stop_patience: int = 0   # stop after this many runs w/o improvement

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SweepSpec":
        metric = d.get("metric", {})
        return cls(
            method=d.get("method", "random"),
            metric_name=metric.get("name", "eval_loss"),
            metric_goal=metric.get("goal", "minimize"),
            parameters=dict(d.get("parameters", {})),
            max_runs=int(d.get("max_runs", 20)),
            seed=int(d.get("seed", 0)),
            n_init=int(d.get("n_init", 5)),
            early_stop_patience=int(d.get("early_stop_patience", 0)),
        )

    @classmethod
    def load(cls, path: str) -> "SweepSpec":
        with open(path) as f:
            if path.endswith((".yaml", ".yml")):
                return cls.from_dict(load_yaml(f.read()))
            return cls.from_dict(json.load(f))


def _sample(spec: SweepSpec, rng: np.random.Generator) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, p in spec.parameters.items():
        if "values" in p:
            out[name] = p["values"][int(rng.integers(0, len(p["values"])))]
        elif "min" in p and "max" in p:
            lo, hi = float(p["min"]), float(p["max"])
            if p.get("log") or p.get("distribution") == "log_uniform_values":
                v = math.exp(rng.uniform(math.log(lo), math.log(hi)))
            else:
                v = rng.uniform(lo, hi)
            out[name] = int(v) if p.get("type") == "int" else v
        else:
            raise ValueError(f"parameter {name}: need 'values' or 'min'/'max'")
    return out


class _BayesPicker:
    """GP-EI candidate picker over [0,1]^d-normalized parameters: an RBF
    kernel on the unit cube (log space for log parameters, index space
    for ``values`` lists), expected improvement maximized over random
    candidates. Numpy only, at the tens-of-runs scale sweep specs
    target."""

    def __init__(self, spec: SweepSpec, rng: np.random.Generator,
                 n_candidates: int = 512, length_scale: float = 0.3):
        self.spec = spec
        self.rng = rng
        self.n_candidates = n_candidates
        self.ls = length_scale
        self.names = list(spec.parameters)

    def _encode_one(self, name: str, value: Any) -> float:
        p = self.spec.parameters[name]
        if "values" in p:
            vals = p["values"]
            return vals.index(value) / max(len(vals) - 1, 1)
        lo, hi = float(p["min"]), float(p["max"])
        if p.get("log") or p.get("distribution") == "log_uniform_values":
            return (math.log(float(value)) - math.log(lo)) / (
                math.log(hi) - math.log(lo) or 1.0)
        return (float(value) - lo) / ((hi - lo) or 1.0)

    def _encode(self, overrides: Dict[str, Any]) -> np.ndarray:
        return np.asarray([self._encode_one(n, overrides[n]) for n in self.names])

    def next(self, tried: List[Dict[str, Any]], ys: List[float]) -> Dict[str, Any]:
        if len(ys) < self.spec.n_init:
            return _sample(self.spec, self.rng)
        cands = [_sample(self.spec, self.rng) for _ in range(self.n_candidates)]
        X = np.stack([self._encode(t) for t in tried])          # (n, d)
        y = np.asarray(ys, np.float64)
        finite = np.isfinite(y)
        if not finite.all():  # failed runs (nan/inf metric): worst observed + 1
            worst = y[finite].max() if finite.any() else 0.0
            y = np.where(finite, y, worst + 1.0)
        mu_y, sd_y = y.mean(), y.std() or 1.0
        yz = (y - mu_y) / sd_y
        C = np.stack([self._encode(c) for c in cands])          # (m, d)

        def rbf(a, b):
            d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            return np.exp(-d2 / (2 * self.ls ** 2))

        K = rbf(X, X) + 1e-4 * np.eye(len(X))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yz))
        Ks = rbf(C, X)                                          # (m, n)
        mu = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)                            # (n, m)
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-9, None)
        sd = np.sqrt(var)
        best = yz.min()  # ys are sign-adjusted so lower is better
        z = (best - mu) / sd
        pdf = np.exp(-0.5 * z ** 2) / math.sqrt(2 * math.pi)
        cdf = 0.5 * (1 + np.vectorize(math.erf)(z / math.sqrt(2)))
        ei = sd * (z * cdf + pdf)
        return cands[int(np.argmax(ei))]


def _grid(spec: SweepSpec) -> List[Dict[str, Any]]:
    names, options = [], []
    for name, p in spec.parameters.items():
        if "values" not in p:
            raise ValueError(f"grid sweeps need 'values' for {name}")
        names.append(name)
        options.append(p["values"])
    return [dict(zip(names, combo)) for combo in itertools.product(*options)]


def run_sweep(
    spec: SweepSpec,
    base_cfg: Any,
    train_fn: Callable[[Any], Any],
    out_dir: str,
    metric_from_result: Optional[Callable[[Any], float]] = None,
) -> Dict[str, Any]:
    """Run the sweep; returns {best: {...}, runs: [...]} (also saved).
    Overrides go through ``config.with_overrides``, which raises on a
    parameter the config lacks."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(spec.seed)
    picker: Optional[_BayesPicker] = None
    if spec.method == "grid":
        candidates = _grid(spec)[: spec.max_runs]
    elif spec.method == "random":
        candidates = [_sample(spec, rng) for _ in range(spec.max_runs)]
    elif spec.method == "bayes":
        candidates = None  # picked sequentially from observed results
        picker = _BayesPicker(spec, rng)
    else:
        raise ValueError(f"unknown sweep method {spec.method!r}")

    def metric_of(result) -> float:
        if metric_from_result is not None:
            return float(metric_from_result(result))
        merged = {**result.last_train_metrics, **result.last_eval_metrics}
        return float(merged[spec.metric_name])

    sign = 1.0 if spec.metric_goal == "minimize" else -1.0
    runs = []
    best = None
    tried: List[Dict[str, Any]] = []
    ys: List[float] = []
    since_best = 0
    for i in range(spec.max_runs if candidates is None else len(candidates)):
        overrides = picker.next(tried, ys) if picker else candidates[i]
        cfg = config_lib.with_overrides(base_cfg, overrides)
        cfg = config_lib.with_overrides(cfg, {"work_dir": os.path.join(out_dir, f"run{i:03d}")}) \
            if hasattr(cfg, "work_dir") else cfg
        log.info("sweep run %d/%d: %s", i + 1, spec.max_runs, overrides)
        result = train_fn(cfg)
        value = metric_of(result)
        runs.append({"overrides": overrides, spec.metric_name: value})
        tried.append(overrides)
        # sign-adjust so the picker always minimizes; nan counts as worst
        ys.append(sign * value if math.isfinite(value) else float("inf"))
        if best is None or sign * value < sign * best[spec.metric_name]:
            best = runs[-1]
            since_best = 0
        else:
            since_best += 1
        with open(os.path.join(out_dir, "sweep.json"), "w") as f:
            json.dump({"best": best, "runs": runs}, f, indent=2)
        if spec.early_stop_patience and since_best >= spec.early_stop_patience:
            log.info("early stop: no improvement in %d runs", since_best)
            break
    log.info("sweep best: %s", best)
    return {"best": best, "runs": runs}


_WORKLOADS = {
    "glove": ("esrecsys_tpu_torch.workloads.glove", "GloveConfig"),
    "playlist": ("esrecsys_tpu_torch.workloads.playlist", "PlaylistConfig"),
    "stl": ("esrecsys_tpu_torch.workloads.stl", "STLConfig"),
    "txt2url": ("esrecsys_tpu_torch.workloads.txt2url", "Txt2UrlConfig"),
}


def main(argv=None):
    """CLI: run a sweep spec against a workload::

        python -m esrecsys_tpu_torch.tools.sweep --spec sweep.yaml \\
            --workload stl --out_dir sweep_out [--device cpu] \\
            [any workload flags: the base config]

    The spec file is read unmodified (YAML or JSON), runs execute in
    sequence on ``--device`` (default: the card), each run trains under
    ``out_dir/runNNN``, and the summary lands in ``out_dir/sweep.json``.
    Prints the best run as one JSON line."""
    import argparse
    import importlib

    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser(description="local sweep runner")
    p.add_argument("--spec", required=True,
                   help="sweep spec path (.yaml/.yml/.json, wandb format)")
    p.add_argument("--workload", required=True, choices=sorted(_WORKLOADS))
    p.add_argument("--out_dir", default="",
                   help="sweep output dir (default: <base work_dir>/sweep)")
    p.add_argument("--device", default="cuda")
    ns, rest = p.parse_known_args(argv)

    mod_name, cfg_name = _WORKLOADS[ns.workload]
    mod = importlib.import_module(mod_name)
    base_cfg = config_lib.from_cli(getattr(mod, cfg_name), rest)
    spec = SweepSpec.load(ns.spec)
    out_dir = ns.out_dir or os.path.join(getattr(base_cfg, "work_dir", "."),
                                         "sweep")
    result = run_sweep(spec, base_cfg,
                       lambda cfg: mod.train(cfg, device=ns.device), out_dir)
    print(json.dumps(result["best"]))
    return result


if __name__ == "__main__":
    main()
