"""Exporters: Prometheus text exposition and optional TensorBoard scalars.

Both read from the registry / event stream without touching devices — the
instrumentation layer already did its phase-boundary readbacks; exporters
are pure host-side formatting.

The PyTorch port's copy of ``dpgo_tpu.obs.exporters``: the same code, with its
imports pointed at the port's own modules.
"""

from __future__ import annotations

import math
import os

from .events import nonfinite_str


def _fmt_labels(labels: dict, extra: dict | None = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    parts = []
    for k, v in sorted(merged.items()):
        # Text exposition format escapes: backslash first, then newline
        # and quote — a raw newline in a label value splits the sample
        # line and corrupts the whole scrape.
        v = (str(v).replace("\\", "\\\\").replace("\n", "\\n")
             .replace('"', '\\"'))
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


def _fmt_value(v: float) -> str:
    # Non-finite spelling shared with the snapshot/event serialization
    # (events.nonfinite_str) — one convention across the whole stack.
    if not math.isfinite(v):
        return nonfinite_str(v)
    return repr(float(v))


def _escape_help(s: str) -> str:
    # HELP text escapes only backslash and newline (the label escaping
    # above additionally covers quotes; HELP is unquoted).
    return str(s).replace("\\", "\\\\").replace("\n", "\\n")


#: Declared-unit spellings -> the canonical Prometheus name suffix.
_UNIT_SUFFIX = {"s": "seconds", "sec": "seconds", "seconds": "seconds",
                "B": "bytes", "bytes": "bytes"}


def exposition_name(name: str, unit: str = "") -> str:
    """The family's name on the wire: Prometheus naming wants the base
    unit as a name suffix (``_seconds``, ``_bytes``) so scrapes validate
    cleanly.  Families that declared a unit but don't carry its token in
    the name get the suffix appended (before a trailing ``_total``);
    names already mentioning the unit anywhere — ``comms_bytes_sent``,
    ``round_latency_seconds`` — pass through untouched, so pre-existing
    dashboards keep their series."""
    suffix = _UNIT_SUFFIX.get(unit or "")
    if suffix is None or suffix in name.split("_"):
        return name
    if name.endswith("_total"):
        return name[:-len("_total")] + f"_{suffix}_total"
    return f"{name}_{suffix}"


def to_prometheus_text(registry) -> str:
    """Prometheus text exposition (format version 0.0.4) of a
    ``MetricsRegistry``: ``# HELP`` / ``# TYPE`` headers per family
    (HELP text escaped per the format spec, falling back to the family
    name so every family is documented), unit-suffixed exposition names
    (``exposition_name``), histogram families expanded to
    ``_bucket``/``_sum``/``_count`` with cumulative ``le`` buckets."""
    lines = []
    for fam in registry.families():
        name = exposition_name(fam.name, fam.unit)
        lines.append(f"# HELP {name} {_escape_help(fam.help or fam.name)}")
        lines.append(f"# TYPE {name} {fam.kind}")
        for key, val in sorted(fam.series().items()):
            labels = dict(key)
            if fam.kind == "histogram":
                cum = 0
                for bound, n in zip(fam.buckets, val["counts"]):
                    cum += n
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(labels, {'le': _fmt_value(bound)})}"
                        f" {cum}")
                cum += val["counts"][-1]
                lines.append(
                    f"{name}_bucket{_fmt_labels(labels, {'le': '+Inf'})}"
                    f" {cum}")
                lines.append(
                    f"{name}_sum{_fmt_labels(labels)}"
                    f" {_fmt_value(val['sum'])}")
                lines.append(
                    f"{name}_count{_fmt_labels(labels)} {val['count']}")
            else:
                lines.append(
                    f"{name}{_fmt_labels(labels)} {_fmt_value(val)}")
    return "\n".join(lines) + "\n"


_NAME_RE = r"[a-zA-Z_:][a-zA-Z0-9_:]*"


def _split_sample_line(line: str):
    """``(name, labels_text_or_None, rest)`` of one exposition sample
    line, or None when the line does not parse as a sample."""
    import re

    m = re.match(rf"^({_NAME_RE})(\{{.*\}})?\s+(\S+)(\s+-?\d+)?\s*$",
                 line)
    if m is None:
        return None
    end = m.end(2) if m.group(2) else m.end(1)
    return m.group(1), m.group(2), line[end:]


def validate_prometheus_text(text: str) -> dict:
    """Line-validate a text exposition (format 0.0.4): every line must be
    a ``# HELP``/``# TYPE``/comment line, blank, or a well-formed sample
    with a finite/±Inf/NaN value.  Raises ``ValueError`` naming the first
    offending line; returns ``{"families": n, "samples": n}`` — the check
    the fleet-obs CI smoke runs on the aggregated scrape."""
    families: set = set()
    samples = 0
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                families.add(parts[2])
            continue
        parsed = _split_sample_line(line)
        if parsed is None:
            raise ValueError(f"malformed exposition line {ln}: {line!r}")
        value = parsed[2].split()[0]
        if value not in ("+Inf", "-Inf", "NaN"):
            try:
                float(value)
            except ValueError:
                raise ValueError(
                    f"non-numeric sample value on line {ln}: {line!r}")
        samples += 1
    return {"families": len(families), "samples": samples}


def relabel_prometheus_text(text: str, extra: dict) -> str:
    """Inject ``extra`` labels into every sample line of an exposition
    (comment/blank lines pass through) — how a fleet aggregator tags each
    child replica's scrape with ``replica="rN"`` before merging."""
    inject = _fmt_labels(extra)
    out = []
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            out.append(line)
            continue
        parsed = _split_sample_line(line)
        if parsed is None:
            out.append(line)   # pass through; validation flags it
            continue
        name, labels, rest = parsed
        if labels:
            merged = _fmt_labels(
                _parse_labels(labels), extra)
            out.append(f"{name}{merged}{rest}")
        else:
            out.append(f"{name}{inject}{rest}")
    return "\n".join(out)


def _parse_labels(labels_text: str) -> dict:
    """Parse ``{a="b",c="d"}`` back into a dict (escapes unwound) — only
    used to merge aggregator labels into already-rendered lines."""
    import re

    out = {}
    for m in re.finditer(rf'({_NAME_RE})="((?:\\.|[^"\\])*)"',
                         labels_text):
        v = (m.group(2).replace('\\"', '"').replace("\\n", "\n")
             .replace("\\\\", "\\"))
        out[m.group(1)] = v
    return out


def merge_prometheus_texts(parts: dict, label: str = "replica") -> str:
    """One exposition from many: each value of ``parts`` (keyed by
    replica id) is relabeled with ``label="<id>"`` and merged grouped by
    family — one ``# HELP``/``# TYPE`` header per family (first writer
    wins; the format forbids duplicates) followed by every contributor's
    samples, so strict scrapers see no interleaved families.  A falsy
    key ("" — the aggregator's own registry) passes through unlabeled:
    its samples already carry whatever identity they need."""
    order: list[str] = []
    headers: dict = {}
    samples: dict = {}
    for rid in sorted(parts):
        text = relabel_prometheus_text(parts[rid], {label: rid}) \
            if rid else parts[rid]
        fam = ""
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith("#"):
                toks = line.split(None, 3)
                if len(toks) >= 3 and toks[1] in ("HELP", "TYPE"):
                    fam = toks[2]
                    if fam not in headers:
                        headers[fam] = []
                        samples[fam] = []
                        order.append(fam)
                    if toks[1] not in {h.split(None, 3)[1]
                                       for h in headers[fam]}:
                        headers[fam].append(line)
                continue
            if fam not in samples:
                headers[fam] = []
                samples[fam] = []
                order.append(fam)
            samples[fam].append(line)
    out: list[str] = []
    for fam in order:
        out.extend(headers[fam])
        out.extend(samples[fam])
    return "\n".join(out) + ("\n" if out else "")


def write_tensorboard_scalars(run_dir: str, events: list[dict],
                              logdir: str | None = None) -> str | None:
    """Export the stream's ``metric`` events as TensorBoard scalars.

    Optional: uses whichever summary writer the environment already has
    (``tensorboardX`` or TensorFlow's), returns None — without raising —
    when neither is importable, so the core subsystem carries no
    TensorBoard dependency.  Scalars are keyed by metric name, stepped by
    the event's ``iteration`` field when present (else its sequence
    number), and stamped with the event's wall time.
    """
    writer_cls = None
    try:
        from tensorboardX import SummaryWriter as writer_cls  # noqa: N813
    except ImportError:
        try:
            from tensorflow.summary import create_file_writer  # noqa: F401
            import tensorflow as tf
        except ImportError:
            return None
        logdir = logdir or os.path.join(run_dir, "tensorboard")
        w = tf.summary.create_file_writer(logdir)
        with w.as_default():
            for ev in events:
                if ev.get("event") != "metric":
                    continue
                v = ev.get("value")
                if not isinstance(v, (int, float)):
                    continue
                step = int(ev.get("iteration", ev.get("seq", 0)))
                tf.summary.scalar(ev["metric"], v, step=step)
        w.flush()
        return logdir
    logdir = logdir or os.path.join(run_dir, "tensorboard")
    w = writer_cls(logdir)
    try:
        for ev in events:
            if ev.get("event") != "metric":
                continue
            v = ev.get("value")
            if not isinstance(v, (int, float)):
                continue
            step = int(ev.get("iteration", ev.get("seq", 0)))
            w.add_scalar(ev["metric"], v, global_step=step,
                         walltime=ev.get("t_wall"))
    finally:
        w.close()
    return logdir
