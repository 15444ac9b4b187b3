"""Prometheus text exposition (format 0.0.4): render and validate.

The port's copy of the JAX package's ``telemetry/exposition.py``, unchanged
in what it renders and validates; :func:`samples`, a reader of a scrape
for scripts and tests (``chip_smoke.py`` reads node processes with it),
and :meth:`Exposition.registries`, the registries' part of a scrape that
the node and the miner share, are the port's own.

The render side replaces the string-building previously inlined in
``node/app.py h_metrics``: every name passes :func:`sanitize` (the
dotted registry names — ``resilience.propagate_timeouts`` — are
illegal as-is), histograms are accumulated into cumulative
``le``-labelled buckets, and the correct content type is exported as
:data:`CONTENT_TYPE`.

The validate side is a mini-parser of the same format used by the
exposition test and ``make metrics-check``: it checks every sample
name against the legal-name grammar, ``le`` label ordering, cumulative
bucket monotonicity, and the ``_count`` == +Inf-bucket invariant for
every exported histogram."""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

from . import metrics

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_BAD_CHAR_RE = re.compile(r"[^a-zA-Z0-9_:]")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*|\S+)"      # name (validated separately)
    r"(?:\{([^}]*)\})?"                       # optional label set
    r"\s+(\S+)"                               # value
    r"(?:\s+\S+)?$")                          # optional timestamp
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
# OpenMetrics-style exemplar suffix: ` # {label="..."} value [ts]`.
# Strictly an extension of the 0.0.4 grammar — rendered only on bucket
# lines that carry an attached exemplar; validate() accepts and checks
# it (label grammar, float value, value within the bucket's le bound).
_EXEMPLAR_RE = re.compile(
    r"^\{((?:[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\"(?:,\s*)?)*)\}"
    r"\s+(\S+)(?:\s+\S+)?$")


def sanitize(name: str) -> str:
    """Map an internal dotted metric name onto the legal grammar."""
    safe = _BAD_CHAR_RE.sub("_", name)
    if not safe or not _NAME_RE.match(safe):
        safe = "_" + safe
    return safe


def _escape_label(value: str) -> str:
    """Escape a label *value* (backslash, quote, newline).  Label values
    take the full escaped grammar — running them through :func:`sanitize`
    would corrupt digit-leading trace ids with a ``_`` prefix."""
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(value: float) -> str:
    if isinstance(value, float) and not value.is_integer():
        return repr(value)
    return str(int(value))


class Exposition:
    """Line builder for one /metrics response."""

    def __init__(self, prefix: str = "upow"):
        self.prefix = prefix
        self.lines: List[str] = []

    def _name(self, name: str) -> str:
        return sanitize(f"{self.prefix}_{name}")

    def gauge(self, name: str, value, help_text: str = "") -> None:
        full = self._name(name)
        if help_text:
            self.lines.append(f"# HELP {full} {help_text}")
        self.lines.append(f"# TYPE {full} gauge")
        self.lines.append(f"{full} {_fmt(value)}")

    def counter(self, name: str, value, help_text: str = "") -> None:
        full = self._name(name)
        if not full.endswith("_total"):
            full += "_total"
        if help_text:
            self.lines.append(f"# HELP {full} {help_text}")
        self.lines.append(f"# TYPE {full} counter")
        self.lines.append(f"{full} {_fmt(value)}")

    def histogram(self, name: str, bounds: Sequence[float],
                  counts: Sequence[int], total: float, summed: float,
                  help_text: str = "",
                  exemplars: Optional[Dict[int, dict]] = None) -> None:
        """``counts`` per-bucket with +Inf overflow last (registry shape).

        ``exemplars`` maps bucket index (0..len(bounds), +Inf last) to
        ``{"trace_id", "value"}``; a bucket with one gets the
        OpenMetrics exemplar suffix ``# {trace_id="..."} value``."""
        full = self._name(name)
        if help_text:
            self.lines.append(f"# HELP {full} {help_text}")
        self.lines.append(f"# TYPE {full} histogram")
        ex = exemplars or {}

        def _suffix(idx: int) -> str:
            e = ex.get(idx)
            if not e or not e.get("trace_id"):
                return ""
            return (f' # {{trace_id="{_escape_label(str(e["trace_id"]))}"}}'
                    f' {e["value"]:.6f}')

        cum = 0
        for i, (bound, count) in enumerate(zip(bounds, counts)):
            cum += count
            self.lines.append(
                f'{full}_bucket{{le="{bound}"}} {cum}{_suffix(i)}')
        cum += counts[-1]
        self.lines.append(
            f'{full}_bucket{{le="+Inf"}} {cum}{_suffix(len(bounds))}')
        self.lines.append(f"{full}_sum {summed:.6f}")
        self.lines.append(f"{full}_count {int(total)}")

    def span_stats(self, name: str, agg: dict) -> None:
        full = sanitize(f"{self.prefix}_span_{name}")
        self.lines.append(f"# TYPE {full}_count counter")
        self.lines.append(f"{full}_count {agg['count']}")
        self.lines.append(f"# TYPE {full}_seconds_total counter")
        self.lines.append(f"{full}_seconds_total {agg['total_s']:.6f}")
        self.lines.append(f"# TYPE {full}_seconds_max gauge")
        self.lines.append(f"{full}_seconds_max {agg['max_s']:.6f}")

    def registries(self) -> None:
        """Every counter, span and histogram of the registries in scope
        (:mod:`.metrics`): the tail of the node's and the miner's
        ``/metrics``."""
        for name, value in sorted(metrics.counters().items()):
            self.counter(name, value)
        for name, st in sorted(metrics.stats().items()):
            self.span_stats(name, st)
        for name, h in sorted(metrics.histograms().items()):
            self.histogram(name, h["bounds"], h["counts"], h["count"],
                           h["sum"], exemplars=h.get("exemplars"))

    def render(self) -> str:
        return "\n".join(self.lines) + "\n"


# ---------------------------------------------------------- validator ---

def _parse_le(raw: str) -> float:
    if raw == "+Inf":
        return math.inf
    return float(raw)


def _split_exemplar(line: str) -> Tuple[str, Optional[str]]:
    """Split a sample line into (sample, exemplar_raw or None).

    The ``' # {'`` separator only counts *outside* the label set: a
    quoted label value may legitimately contain it (only backslash,
    quote and newline are escaped), so scanning starts after the label
    set's closing ``}`` — found by walking the braces quote- and
    escape-aware, not by ``find``."""
    space = line.find(" ")
    brace = line.find("{")
    start = 0
    if brace != -1 and (space == -1 or brace < space):
        # a label set opens directly after the name (no space before
        # it); any later '{' belongs to an exemplar or a label value
        i, in_str, esc = brace + 1, False, False
        while i < len(line):
            ch = line[i]
            if in_str:
                if esc:
                    esc = False
                elif ch == "\\":
                    esc = True
                elif ch == '"':
                    in_str = False
            elif ch == '"':
                in_str = True
            elif ch == "}":
                start = i + 1
                break
            i += 1
    cut = line.find(" # {", start)
    if cut == -1:
        return line, None
    return line[:cut], line[cut + 3:]


def validate(text: str) -> List[str]:
    """Return a list of format violations ([] == clean)."""
    errors: List[str] = []
    # histogram name -> [(le, cumulative_count)]; plain name -> value
    buckets: Dict[str, List[Tuple[float, float]]] = {}
    values: Dict[str, float] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                errors.append(f"line {lineno}: malformed comment {line!r}")
            elif not _NAME_RE.match(parts[2]):
                errors.append(
                    f"line {lineno}: illegal metric name {parts[2]!r}")
            continue
        line, exemplar_raw = _split_exemplar(line)
        m = _SAMPLE_RE.match(line)
        if m is None:
            errors.append(f"line {lineno}: unparseable sample {line!r}")
            continue
        name, labels_raw, value_raw = m.group(1), m.group(2), m.group(3)
        exemplar_value = None
        if exemplar_raw is not None:
            em = _EXEMPLAR_RE.match(exemplar_raw)
            if em is None:
                errors.append(
                    f"line {lineno}: malformed exemplar {exemplar_raw!r}")
            elif not (name.endswith("_bucket") or name.endswith("_total")):
                errors.append(
                    f"line {lineno}: exemplar on non-bucket/counter "
                    f"sample {name!r}")
            else:
                try:
                    exemplar_value = float(em.group(2))
                except ValueError:
                    errors.append(
                        f"line {lineno}: bad exemplar value "
                        f"{em.group(2)!r}")
        if not _NAME_RE.match(name):
            errors.append(f"line {lineno}: illegal metric name {name!r}")
            continue
        try:
            value = float(value_raw)
        except ValueError:
            errors.append(f"line {lineno}: bad value {value_raw!r}")
            continue
        labels = dict(_LABEL_RE.findall(labels_raw)) if labels_raw else {}
        if name.endswith("_bucket") and "le" in labels:
            try:
                le = _parse_le(labels["le"])
            except ValueError:
                errors.append(
                    f"line {lineno}: bad le value {labels['le']!r}")
                continue
            if (exemplar_value is not None and le != math.inf
                    and exemplar_value > le):
                errors.append(
                    f"line {lineno}: exemplar value {exemplar_value} "
                    f"exceeds bucket le={labels['le']}")
            buckets.setdefault(name[:-len("_bucket")], []).append(
                (le, value))
        else:
            values[name] = value
    for hist, series in buckets.items():
        les = [le for le, _ in series]
        if les != sorted(les):
            errors.append(f"{hist}: le labels not in ascending order")
        if len(set(les)) != len(les):
            errors.append(f"{hist}: duplicate le label")
        if not les or les[-1] != math.inf:
            errors.append(f"{hist}: missing le=\"+Inf\" bucket")
        counts = [c for _, c in series]
        if any(b > a for b, a in zip(counts, counts[1:])):
            errors.append(f"{hist}: cumulative bucket counts not monotone")
        count_name = hist + "_count"
        if count_name not in values:
            errors.append(f"{hist}: missing {count_name}")
        elif les and les[-1] == math.inf and counts[-1] != values[count_name]:
            errors.append(
                f"{hist}: _count {values[count_name]} != +Inf bucket "
                f"{counts[-1]}")
        if hist + "_sum" not in values:
            errors.append(f"{hist}: missing {hist}_sum")
    return errors


def samples(text: str) -> Dict[str, float]:
    """A scrape's samples as ``{name: value}``, a labelled sample keyed
    by its name and label set as written (``x_bucket{le="0.1"}``);
    comments and exemplars are left out.  Raises ValueError on a line
    :func:`validate` would call unparseable."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(_split_exemplar(line)[0])
        if m is None:
            raise ValueError(f"unparseable sample {line!r}")
        name, labels = m.group(1), m.group(2)
        out[name + ("{%s}" % labels if labels is not None else "")] = \
            float(m.group(3))
    return out
