"""The rules ``BENCHMARK.json`` and the files the harness finds by name in it
keep, read from each cell's own files: its traffic's driver, that driver's
``CHECKS``, its control and faults, its configuration's cuts and precision,
its chips.

``spec_problems(spec, root)`` returns every rule the spec breaks, each as
``"<rule>: <what>"``, so that a test can ask for none, or for one rule's.
A driver and its faults are loaded from the tree's files, as
``bench/run.py`` loads a metric's reader.
"""
from __future__ import annotations

import ast
import importlib.util
import json
import re
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
COUNTS = {"configs": 24, "workloads": 24, "end_to_end": 16,
          "per_layer": 128}
PRECISIONS = ("float32", "bfloat16")
# the control's dtype: the nearest below the configuration's precision
LOWER = {"float32": ("tf32", "bfloat16"),
         "bfloat16": ("float8_e4m3fn", "float8_e5m2", "int8")}
# The cuts a configuration may take, by the key that counts what is cut:
# its depth, and this chip's share of a layer (the experts, the heads and
# the rows of the vocabulary it holds).  Every other key keeps its
# published value, a width above all.
CUTS = {"num_hidden_layers": "depth", "num_layers": "depth",
        "n_layers": "depth", "n_layer": "depth",
        "n_routed_experts": "experts", "num_experts": "experts",
        "num_local_experts": "experts", "moe_num_experts": "experts",
        "num_attention_heads": "heads", "num_key_value_heads": "heads",
        "n_heads": "heads", "n_kv_heads": "heads",
        "vocab_size": "vocabulary"}
# the leading dense layers, which a cut in depth keeps beside four more
LEADING_DENSE = ("first_k_dense_replace", "num_dense_layers",
                 "n_dense_first_layers")
REFERENCE_IMPORTS = {"__future__", "typing", "torch"}
MAX_BYTES = 64 * 1024


def spec_problems(spec: dict, root: Path) -> list:
    """Every rule ``spec`` breaks in the tree at ``root``."""
    root = Path(root)
    found = []
    for rule, check in RULES.items():
        try:
            found += [f"{rule}: {msg}" for msg in check(spec, root)]
        except (KeyError, TypeError, AttributeError) as e:
            found.append(f"{rule}: an entry cannot be read ({e!r})")
    return found


def rules_broken(problems) -> set:
    return {p.split(":", 1)[0] for p in problems}


def _entries(spec, section):
    got = spec.get(section)
    return got if isinstance(got, list) else []


def _load(path: Path):
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError):
        return None


def imported(path: Path) -> set:
    """The top-level names of the modules ``path`` imports, whole."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _top_level(path: Path):
    try:
        return ast.parse(path.read_text()).body
    except (OSError, SyntaxError):
        return None


def load_module(path: Path):
    """The module at ``path``, run under a name of its own and kept out of
    ``sys.modules``; whatever stops it loading is raised."""
    spec = importlib.util.spec_from_file_location(
        f"bench_spec_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cells(spec) -> dict:
    return {w["name"]: w for w in _entries(spec, "workloads")}


def _reported(spec, cell: str) -> tuple:
    """The end-to-end and per-layer metrics ``cell`` reports, as
    ``bench/run.py``'s ``load_cell`` takes them."""
    e2e = [m for m in _entries(spec, "end_to_end")
           if cell in m.get("workloads", [cell])]
    shown = {m["name"] for m in e2e}
    layer = [m for m in _entries(spec, "per_layer")
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in shown)]
    return e2e, layer


def _traffic(root: Path, w: dict):
    return _load(root / "bench" / "traffic" / f"{w['traffic']}.json")


def _config(spec, root: Path, name: str):
    for c in _entries(spec, "configs"):
        if c["name"] == name:
            return _load(root / c["file"])
    return None


def driver_checks(root: Path, driver: str):
    """The ``CHECKS`` of ``bench/drivers/<driver>.py``, or None where the
    module does not load or lacks a ``run`` function or a tuple of names
    under ``CHECKS``."""
    try:
        mod = load_module(root / "bench" / "drivers" / f"{driver}.py")
    except Exception:                    # noqa: BLE001 - any, reported
        return None
    checks = getattr(mod, "CHECKS", None)
    if not callable(getattr(mod, "run", None)) or not (
            isinstance(checks, tuple) and checks
            and all(isinstance(c, str) for c in checks)):
        return None
    return checks


def top_level(spec, root):
    if set(spec) != TOP:
        yield f"keys {sorted(spec)}, not {sorted(TOP)}"
    seconds = spec.get("run_seconds")
    if not (isinstance(seconds, int) and 1 <= seconds <= 51):
        yield f"run_seconds {seconds!r} is not a whole number 1..51"
    path = root / "BENCHMARK.json"
    if not path.is_file():
        yield "no BENCHMARK.json at the root"
    elif path.stat().st_size > MAX_BYTES:
        yield f"{path.stat().st_size} bytes, over {MAX_BYTES}"


def names(spec, root):
    for section, want in KEYS.items():
        entries = _entries(spec, section)
        if not 1 <= len(entries) <= COUNTS[section]:
            yield f"{section} has {len(entries)} entries"
        seen = [e.get("name") for e in entries]
        for dup in sorted({n for n in seen if seen.count(n) > 1}):
            yield f"{section} names {dup!r} twice"
        for e in entries:
            if set(e) - {"workloads"} != want or (
                    "workloads" in e and section in ("configs",
                                                     "workloads")):
                yield f"{section} {e.get('name')!r} has keys {sorted(e)}"
            for key in ("name", "config", "traffic"):
                if key in e and not NAME.match(str(e[key])):
                    yield f"{section} {key} {e[key]!r} is not a name"
            if "unit" in e and not UNIT.match(str(e["unit"])):
                yield f"{e['name']!r} unit {e['unit']!r}"
            if "better" in e and e["better"] not in ("lower", "higher"):
                yield f"{e['name']!r} better {e['better']!r}"
            for key in ("why", "layer", "source"):
                text = e.get(key, "x")
                if not (isinstance(text, str) and 1 <= len(text) <= 200
                        and "\n" not in text and "\t" not in text):
                    yield f"{e.get('name')!r} {key} is not 1..200 " \
                          "characters on one line"
    pairs = [(w["config"], w["traffic"]) for w in _entries(spec,
                                                            "workloads")]
    for pair in sorted({p for p in pairs if pairs.count(p) > 1}):
        yield f"configuration and traffic {pair} appear twice"


def bounds(spec, root):
    for m in _entries(spec, "end_to_end"):
        if not 0.01 <= m["bound"] <= 0.25:
            yield f"{m['name']!r} bound {m['bound']} is not in 0.01..0.25"
        if m["source"] not in ("host_clock", "device_trace"):
            yield f"{m['name']!r} source {m['source']!r}"
    for m in _entries(spec, "per_layer"):
        if m["source"] not in ("device_trace", "program_span",
                               "program_counter", "host_clock"):
            yield f"{m['name']!r} source {m['source']!r}"


def rooflines(spec, root):
    for m in _entries(spec, "per_layer"):
        if m["unit"] == "%" and "roofline" in m["name"] \
                and not m["name"].endswith("_roofline"):
            yield f"{m['name']!r} is a roofline share not named *_roofline"


def metrics(spec, root):
    cells = _cells(spec)
    e2e = {m["name"] for m in _entries(spec, "end_to_end")}
    if "setup_s" not in e2e:
        yield "no end-to-end metric setup_s"
    for m in _entries(spec, "end_to_end") + _entries(spec, "per_layer"):
        for c in m.get("workloads", []):
            if c not in cells:
                yield f"{m['name']!r} lists {c!r}, which is no cell"
    for m in _entries(spec, "per_layer"):
        if m["moves"] not in e2e:
            yield f"{m['name']!r} moves {m['moves']!r}, no end-to-end metric"
        body = _top_level(root / "bench" / "metrics" / f"{m['name']}.py")
        if body is None or not any(isinstance(n, ast.FunctionDef)
                                   and n.name == "read" for n in body):
            yield f"bench/metrics/{m['name']}.py defines no read"
    for cell in cells:
        got, layer = _reported(spec, cell)
        shown = {m["name"] for m in got}
        if "setup_s" not in shown or len(shown) < 2:
            yield f"{cell!r} reports end-to-end {sorted(shown)}: setup_s " \
                  "and one more are needed"
        if not layer:
            yield f"{cell!r} reports no per-layer metric"
        for m in layer:
            if m["moves"] not in shown:
                yield f"{cell!r} reports {m['name']!r} but not what it " \
                      f"moves, {m['moves']!r}"


def driver(spec, root):
    for name, w in _cells(spec).items():
        traffic = _traffic(root, w)
        if traffic is None:
            yield f"{name!r}: no bench/traffic/{w['traffic']}.json"
        elif driver_checks(root, str(traffic.get("driver"))) is None:
            yield f"{name!r}: bench/drivers/{traffic.get('driver')}.py " \
                  "does not load or defines no run and CHECKS"


def limits(spec, root):
    for name, w in _cells(spec).items():
        traffic = _traffic(root, w)
        checks = traffic and driver_checks(root, str(traffic.get("driver")))
        if not checks:
            continue          # the driver rule's to report
        cell = _load(root / "bench" / "workloads" / f"{name}.json")
        got = (cell or {}).get("limits")
        if not isinstance(got, dict) or set(got) != set(checks):
            yield f"{name!r}: limits {sorted(got or {})}, the driver's " \
                  f"CHECKS {sorted(checks)}"


def faults(spec, root):
    """Each cell's driver has ``bench/faults/<driver>.py``: a ``CONTROL``
    one precision below the cell's configuration's, and ``FAULTS``."""
    for name, w in _cells(spec).items():
        traffic = _traffic(root, w)
        drv = str((traffic or {}).get("driver"))
        if not driver_checks(root, drv):
            continue          # the driver rule's to report
        path = f"bench/faults/{drv}.py"
        try:
            mod = load_module(root / path)
        except Exception as e:           # noqa: BLE001 - any, reported
            yield f"{name!r}: {path} does not load ({e!r})"
            continue
        prec = (_config(spec, root, w["config"]) or {}).get("precision")
        control = getattr(mod, "CONTROL", None)
        got = control.get(prec) if isinstance(control, dict) else None
        if prec in LOWER and got not in LOWER[prec]:
            yield f"{name!r}: {path} gives the control {got!r} for " \
                  f"{prec}, not one of {', '.join(LOWER[prec])}"
        plants = getattr(mod, "FAULTS", None)
        if not (isinstance(plants, dict) and plants):
            yield f"{name!r}: {path} defines no FAULTS"
            continue
        for fault, entry in plants.items():
            if not (isinstance(entry, tuple) and len(entry) == 3
                    and isinstance(entry[1], str)
                    and callable(getattr(entry[0], entry[1], None))
                    and callable(entry[2])):
                yield f"{name!r}: {path} fault {fault!r} is not " \
                      "(module, attribute, replacement) of a function"


def chips(spec, root):
    cells = _entries(spec, "workloads")
    for w in cells:
        if w["chips"] not in (1, 4):
            yield f"{w['name']!r} asks for {w['chips']!r} chips, not 1 or 4"
    four = [w["name"] for w in cells if w["chips"] == 4]
    if len(four) > max(1, len(cells) // 4):
        yield f"{len(four)} of {len(cells)} cells ask for 4 chips: " \
              f"{', '.join(four)}"


def configs(spec, root):
    files = [c["file"] for c in _entries(spec, "configs")]
    paths = spec.get("paths", [])
    used = {w["config"] for w in _entries(spec, "workloads")}
    for c in _entries(spec, "configs"):
        if files.count(c["file"]) > 1 or not any(
                c["file"].startswith(p.rstrip("/") + "/") for p in paths):
            yield f"{c['name']!r} file {c['file']!r} is shared or outside " \
                  "paths"
        if c["name"] not in used:
            yield f"{c['name']!r} is used by no cell"
        cfg = _load(root / c["file"])
        if not isinstance(cfg, dict) or cfg.get("name") != c["name"]:
            yield f"{c['file']!r} is not the configuration {c['name']!r}"
    for w in _entries(spec, "workloads"):
        if w["config"] not in {c["name"] for c in _entries(spec, "configs")}:
            yield f"{w['name']!r} names no configuration {w['config']!r}"


def cuts(spec, root):
    for c in _entries(spec, "configs"):
        cfg = _load(root / c["file"])
        reduced = c["reduced"]
        if not isinstance(cfg, dict) or not isinstance(reduced, list):
            continue          # the configs rule's to report
        if len(reduced) > 16:
            yield f"{c['name']!r} reduces {len(reduced)} keys, over 16"
        if not reduced:
            continue
        published = cfg.get("published")
        published = published if isinstance(published, dict) else {}
        deployment = cfg.get("deployment")
        if not (isinstance(deployment, str) and deployment.strip()):
            yield f"{c['name']!r} is cut and states no deployment"
        for key in reduced:
            if not NAME.match(str(key)):
                yield f"{c['name']!r} reduces {key!r}, not a name"
            if key not in cfg:
                yield f"{c['name']!r} reduces {key!r}, no key of its file"
            if key not in published:
                yield f"{c['name']!r} reduces {key!r} with no published " \
                      "value"
            if key not in CUTS:
                yield f"{c['name']!r} reduces {key!r}, not a cut of depth " \
                      "or of this chip's share (experts, heads, " \
                      "vocabulary rows)"
            elif key in cfg and key in published:
                least = _floor(CUTS[key], cfg, published[key])
                if cfg[key] < least:
                    yield f"{c['name']!r} holds {cfg[key]} of {key!r}, " \
                          f"under its floor {least}"


def _floor(cut: str, cfg: dict, published):
    """The least a cut keeps: the leading dense layers and four more, 8
    experts, an eighth of the vocabulary, one head (never more than the
    published count)."""
    lead = next((cfg[k] for k in LEADING_DENSE if k in cfg), 0)
    least = {"depth": lead + 4, "experts": 8, "heads": 1,
             "vocabulary": -(-published // 8)}[cut]
    return min(least, published)


def precision(spec, root):
    for c in _entries(spec, "configs"):
        cfg = _load(root / c["file"])
        if isinstance(cfg, dict) and cfg.get("precision") not in PRECISIONS:
            yield f"{c['name']!r} precision {cfg.get('precision')!r}, not " \
                  f"one of {', '.join(PRECISIONS)}"


def reference(spec, root):
    for path in sorted((root / "bench" / "reference").rglob("*.py")):
        got = imported(path)
        if got - REFERENCE_IMPORTS:
            yield f"{path.relative_to(root)} imports " \
                  f"{', '.join(sorted(got - REFERENCE_IMPORTS))}"


RULES = {f.__name__: f for f in (top_level, names, bounds, rooflines,
                                 metrics, driver, limits, faults, chips,
                                 configs, cuts, precision, reference)}
