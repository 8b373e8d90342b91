"""The reference's dry-run sweep against the port's, cell by cell.

Not a test module (pytest collects ``test_*.py`` only).  Both packages
write one JSON per cell, ``<arch>__<shape>__<mesh>.json``:

  PYTHONPATH=src python -m repro.launch.dryrun --all --mesh both \\
      --out REF_DIR
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --device cpu --out PORT_DIR
  PYTHONPATH=src python tests/dryrun_sweep_compare.py REF_DIR PORT_DIR \\
      [--markdown] [--card CARD_DIR] [--as-ref AS_REF_DIR]

prints one row per cell: ok or the error on each side, the mode and
microbatches, rank 0's dot FLOPs on both sides and their ratio, temp and
peak-live bytes on both sides and their ratio, the collective bytes by
kind on both sides, the port's trace seconds (and, with ``--card``, the
trace seconds of a sweep on the card), and whether the cell is held
(``HELD``): the port runs wherever the reference compiles, its FLOPs are
within 0.8-1.25x of the reference's and its peak-live bytes at most 2.0x.
Collective bytes are printed, not held: the two packages' collectives
are not the same ops kind for kind.  With ``--as-ref``, a directory of
the port's cells traced ``--as-reference`` (``repro_torch.launch.dryrun
--as-reference``: the attention's masked kv blocks and a prefill's every
logit counted, as the reference computes), each such cell also gets
that reading, and a prefill cell among them is held by it: its
as-reference FLOPs within the bounds, its peak (the port's own trace's)
at most the bound.  A prefill is where the two count differently, so a
raw reading there can hide a rank's repeated work (or show a gap that
is only counting).

  PYTHONPATH=src python tests/dryrun_sweep_compare.py --reference-dots \\
      ARCH SHAPE MESH [--top N]

compiles one cell of the reference's dry-run (in this process, which
the reference's module sets up for 512 host devices) and prints its dot
FLOPs by shapes, each scaled by the trip counts of the loops around it as
``repro.launch.hlo_parse`` scales them; the port's side of the same
breakdown is ``repro_torch.launch.dryrun --by-op``.
``--reference-collectives ARCH SHAPE MESH`` prints the same cell's
collectives so: each kind and output shape with its operand bytes a step
(``hlo_parse``'s collective bytes) and its count a step.

  PYTHONPATH=src python tests/dryrun_sweep_compare.py --as-reference \\
      ARCH SHAPE MESH REF_DIR

traces the port's cell (on the CPU) as the reference counts two things
it does differently, and prints its FLOPs against the reference's (its
peak is not the port's: the logits of every position are live at
once): the attention computes every kv block, the masked ones too
(the port skips a block no query of which sees a key), and a prefill
computes the logits of every position before it keeps the last (the
port's head runs on the last position only).  A cell whose gap closes
so is attributed to those two.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from collections import defaultdict
from pathlib import Path

FLOPS_BOUNDS = (0.8, 1.25)
PEAK_BOUND = 2.0
ABBREV = {"all-gather": "ag", "all-reduce": "ar", "reduce-scatter": "rs",
          "all-to-all": "a2a", "collective-permute": "cp",
          "broadcast": "bc", "reduce": "red"}
MESH_NAMES = {"pod_16x16": "pod", "multipod_2x16x16": "multipod"}


def load(directory: Path) -> dict:
    """(arch, shape, mesh) -> the cell's JSON, from one sweep's files."""
    out = {}
    for fn in sorted(Path(directory).glob("*__*__*.json")):
        arch, shape, mesh = fn.stem.split("__")
        out[(arch, shape, mesh)] = json.loads(fn.read_text())
    return out


def _collectives(res: dict) -> str:
    coll = res.get("hlo", {}).get("collective_bytes", {})
    return ", ".join(f"{ABBREV.get(k, k)} {v:.3g}"
                     for k, v in sorted(coll.items(), key=lambda kv: -kv[1])
                     if v) or "-"


def compare(ref: dict, port: dict) -> dict:
    """One row's figures; ``held`` says whether the cell holds."""
    row = {"ref_ok": "error" not in ref, "port_ok": "error" not in port,
           "ref_error": ref.get("error", "")[:120],
           "port_error": port.get("error", "")[:120],
           "mode": port.get("mode", ref.get("mode", "")),
           "microbatches": port.get("microbatches",
                                    ref.get("microbatches", ""))}
    if not (row["ref_ok"] and row["port_ok"]):
        # a cell the reference fails is the reference's; one it compiles
        # and the port fails is not held
        row["held"] = not row["ref_ok"] and row["port_ok"]
        return row
    rf, pf = ref["hlo"]["per_device_flops"], port["hlo"]["per_device_flops"]
    rm, pm = ref["memory_per_device"], port["memory_per_device"]
    row.update(
        ref_flops=rf, port_flops=pf, flops_ratio=pf / rf if rf else None,
        ref_temp=rm["temp_bytes"], port_temp=pm["temp_bytes"],
        ref_peak=rm["peak_live_bytes"], port_peak=pm["peak_live_bytes"],
        peak_ratio=pm["peak_live_bytes"] / rm["peak_live_bytes"],
        ref_coll=_collectives(ref), port_coll=_collectives(port),
        trace_s=port["hlo"].get("trace_s"),
        ref_compile_s=ref.get("compile_s"))
    row["held"] = (row["flops_ratio"] is not None
                   and FLOPS_BOUNDS[0] <= row["flops_ratio"] <= FLOPS_BOUNDS[1]
                   and row["peak_ratio"] <= PEAK_BOUND)
    return row


def rows(ref_dir: Path, port_dir: Path, card_dir=None, as_ref_dir=None):
    ref, port = load(ref_dir), load(port_dir)
    card = load(card_dir) if card_dir else {}
    as_ref = load(as_ref_dir) if as_ref_dir else {}
    for key in sorted(set(ref) | set(port)):
        missing = {"error": "no file"}
        row = compare(ref.get(key, missing), port.get(key, missing))
        if card:
            c = card.get(key, missing)
            row["card_trace_s"] = ("error" if "error" in c
                                   else c["hlo"].get("trace_s"))
        if key in as_ref and row.get("ref_flops"):
            held_as_reference(row, as_ref[key])
        yield key, row


def held_as_reference(row: dict, res: dict) -> None:
    """``row`` given the cell's trace counted as the reference counts
    (``res``): its FLOPs and their ratio to the reference's, and for a
    prefill cell, ``held`` by that ratio and the row's own peak."""
    if "error" in res:
        row["as_ref_flops"] = row["as_ref_ratio"] = None
        return
    row["as_ref_flops"] = res["hlo"]["per_device_flops"]
    row["as_ref_ratio"] = row["as_ref_flops"] / row["ref_flops"]
    if res.get("kind") == "prefill":
        row["held"] = (FLOPS_BOUNDS[0] <= row["as_ref_ratio"]
                       <= FLOPS_BOUNDS[1]
                       and row["peak_ratio"] <= PEAK_BOUND)


def _fmt(x, spec=".3e"):
    return "-" if x is None else format(x, spec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python tests/dryrun_sweep_compare.py")
    ap.add_argument("dirs", nargs="*",
                    help="the reference's sweep directory, the port's")
    ap.add_argument("--card", default=None,
                    help="a port sweep traced on the card: its trace s")
    ap.add_argument("--as-ref", default=None,
                    help="the port's cells traced --as-reference: their "
                    "FLOPs, and a prefill cell held by them")
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--reference-dots", nargs=3,
                    metavar=("ARCH", "SHAPE", "MESH"))
    ap.add_argument("--reference-collectives", nargs=3,
                    metavar=("ARCH", "SHAPE", "MESH"))
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--as-reference", nargs=4,
                    metavar=("ARCH", "SHAPE", "MESH", "REF_DIR"))
    args = ap.parse_args(argv)
    if args.as_reference:
        arch, shape, mesh, ref_dir = args.as_reference
        res = as_reference(arch, shape, mesh)
        ref = json.loads((Path(ref_dir) / f"{arch}__{shape}__{mesh}.json")
                         .read_text())
        row = compare(ref, res)
        ratio = row.get("flops_ratio")
        within = ratio is not None and \
            FLOPS_BOUNDS[0] <= ratio <= FLOPS_BOUNDS[1]
        print(f"{arch} {shape} {mesh} counted as the reference counts: "
              f"FLOPs {_fmt(row.get('port_flops'))} "
              f"({_fmt(ratio, '.3f')}x the reference's): "
              f"{'within' if within else 'outside'} the bounds")
        return 0
    if args.reference_dots:
        for flops, where in hlo_dots(reference_hlo(
                *args.reference_dots))[:args.top]:
            print(f"{flops:.3e}  {where}")
        return 0
    if args.reference_collectives:
        for nbytes, count, what in hlo_collectives(reference_hlo(
                *args.reference_collectives))[:args.top]:
            print(f"{nbytes:.3e} B  {count:g}x  {what}")
        return 0
    if len(args.dirs) != 2:
        ap.error("give the reference's sweep directory and the port's")
    cols = ["cell", "ref", "port", "mode", "mb", "ref FLOPs", "port FLOPs",
            "ratio", "ref temp B", "port temp B", "ref peak B",
            "port peak B", "ratio", "ref collective B", "port collective B",
            "trace s"] + (["card trace s"] if args.card else []) + (
                ["as-ref FLOPs", "as-ref ratio"] if args.as_ref else []) + [
                "held"]
    sep = " | " if args.markdown else "  "
    if args.markdown:
        print("| " + sep.join(cols) + " |")
        print("|" + "---|" * len(cols))
    else:
        print(sep.join(cols))
    n_held = n = 0
    for (arch, shape, mesh), r in rows(Path(args.dirs[0]),
                                       Path(args.dirs[1]), args.card,
                                       args.as_ref):
        n += 1
        n_held += r["held"]
        cells = [f"{arch} {shape} {MESH_NAMES.get(mesh, mesh)}",
                 "ok" if r["ref_ok"] else f"error: {r['ref_error']}",
                 "ok" if r["port_ok"] else f"error: {r['port_error']}",
                 r["mode"], str(r["microbatches"]),
                 _fmt(r.get("ref_flops")), _fmt(r.get("port_flops")),
                 _fmt(r.get("flops_ratio"), ".2f"),
                 _fmt(r.get("ref_temp")), _fmt(r.get("port_temp")),
                 _fmt(r.get("ref_peak")), _fmt(r.get("port_peak")),
                 _fmt(r.get("peak_ratio"), ".2f"),
                 r.get("ref_coll", "-"), r.get("port_coll", "-"),
                 _fmt(r.get("trace_s"), "")]
        if args.card:
            cells.append(_fmt(r.get("card_trace_s"), ""))
        if args.as_ref:
            cells += [_fmt(r.get("as_ref_flops")),
                      _fmt(r.get("as_ref_ratio"), ".3f")]
        cells.append("HELD" if r["held"] else "NOT HELD")
        print(("| " + sep.join(cells) + " |") if args.markdown
              else sep.join(cells))
    print(f"held {n_held} of {n} cells")
    return 0


def as_reference(arch: str, shape: str, mesh: str) -> dict:
    """``repro_torch.launch.dryrun.run_cell`` on the CPU, traced as the
    reference's compiled step computes (``dryrun.as_reference``: the
    attention's masked kv blocks, a prefill's head on every position);
    the port's values do not change, only what it computes."""
    from repro_torch.launch import dryrun

    return dryrun.run_cell(arch, shape, device="cpu", mesh=mesh,
                           counted_as_reference=True)


# ---------------------------------------------------------------------------
# The reference's dots of one cell, by shapes
# ---------------------------------------------------------------------------

def _multipliers(comps) -> dict:
    """How many times each computation runs per step: the entry once,
    each callee its callers' count times the call's multiplier (a while
    body its trip count), summed over its callers."""
    callers = defaultdict(list)
    for name, c in comps.items():
        if name == "__entry__":
            continue
        for callee, m in c.calls:
            callers[callee].append((name, m))
    entry = comps["__entry__"].name
    memo = {}

    def mult(name, depth=0):
        if name == entry:
            return 1.0
        if name in memo or depth > 64:
            return memo.get(name, 0.0)
        memo[name] = 0.0  # cycle guard
        memo[name] = sum(mult(c, depth + 1) * m for c, m in callers[name])
        return memo[name]

    return {name: mult(name) for name in comps}


def hlo_dots(text: str):
    """[(FLOPs a step, "source:line op_name [out] <- [lhs] contracted"),
    ...] of every ``dot`` in the optimized HLO ``text``, FLOPs as
    ``hlo_parse`` counts them, summed over equal descriptions, largest
    first."""
    from repro.launch.hlo_parse import _SHAPE_RE, parse_hlo

    mult = _multipliers(parse_hlo(text))
    header_re = re.compile(r"^(ENTRY\s+)?%?([\w\.\-]+)\s*\(.*\)\s*->.*{")
    instr_re = re.compile(r"^\s+(ROOT\s+)?%?([\w\.\-]+)\s*=\s*(.*)$")
    out = defaultdict(float)
    cur, dims = None, {}
    for raw in text.splitlines():
        m = header_re.match(raw)
        if m:
            cur, dims = m.group(2), {}
            for pm in re.finditer(r"%?([\w\.\-]+):\s*(\w+)\[([0-9,]*)\]",
                                  raw):
                dims[pm.group(1)] = [int(x) for x in pm.group(3).split(",")
                                     if x]
            continue
        im = instr_re.match(raw) if cur else None
        if not im:
            continue
        name, rest = im.group(2), im.group(3)
        shapes = _SHAPE_RE.findall(rest.split("(", 1)[0])
        out_dims = ([int(x) for x in shapes[0][1].split(",") if x]
                    if shapes else [])
        dims[name] = out_dims
        opm = re.search(r"\)?\s*([a-z][a-z0-9\-]*)\(", rest)
        if not opm or opm.group(1) != "dot":
            continue
        args_m = re.search(r"\((.*?)\)(,|$)", rest)
        operands = re.findall(r"%([\w\.\-]+)", args_m.group(1)) if args_m \
            else []
        lhs = dims.get(operands[0], []) if operands else []
        cd = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", rest)
        contracted = 1
        for ci in (cd.group(1).split(",") if cd else []):
            if ci and int(ci) < len(lhs):
                contracted *= lhs[int(ci)]
        n = 1
        for d in out_dims:
            n *= d
        src = re.search(r'source_file="([^"]*)"\s+source_line=(\d+)', rest)
        where = (f"{Path(src.group(1)).name}:{src.group(2)}" if src
                 else "?")
        op = re.search(r'op_name="([^"]*)"', rest)
        op = op.group(1).split("/")[-1] if op else "?"
        key = (f"{where} {op} [{'x'.join(map(str, out_dims))}] <- "
               f"[{'x'.join(map(str, lhs))}] k={contracted}")
        out[key] += 2.0 * n * contracted * mult.get(cur, 0.0)
    return sorted(((f, k) for k, f in out.items()), key=lambda t: -t[0])


def hlo_collectives(text: str):
    """[(operand bytes a step, count a step, "kind [out shape]"), ...] of
    every collective in the optimized HLO ``text``, bytes as
    ``hlo_parse`` counts them (its operands' bytes), each instruction
    scaled by the trip counts of the loops around it, summed over equal
    descriptions, largest first."""
    from repro.launch.hlo_parse import (_COLLECTIVES, _SHAPE_RE,
                                        _shape_bytes, parse_hlo)

    mult = _multipliers(parse_hlo(text))
    header_re = re.compile(r"^(ENTRY\s+)?%?([\w\.\-]+)\s*\(.*\)\s*->.*{")
    instr_re = re.compile(r"^\s+(ROOT\s+)?%?([\w\.\-]+)\s*=\s*(.*)$")
    out = defaultdict(lambda: [0.0, 0.0])
    cur, sizes = None, {}
    for raw in text.splitlines():
        m = header_re.match(raw)
        if m:
            cur, sizes = m.group(2), {}
            continue
        im = instr_re.match(raw) if cur else None
        if not im:
            continue
        name, rest = im.group(2), im.group(3)
        opm = re.search(r"\)?\s*([a-z][a-z0-9\-]*)\(", rest)
        kind = opm.group(1) if opm else ""
        head = rest[:opm.start(1)] if opm else rest  # the output shape(s)
        sizes[name] = sum(_shape_bytes(dt, dims)[1]
                          for dt, dims in _SHAPE_RE.findall(head))
        if kind not in _COLLECTIVES:
            continue
        args_m = re.search(r"\((.*?)\)(,|$)", rest)
        operands = re.findall(r"%([\w\.\-]+)", args_m.group(1)) \
            if args_m else []
        nbytes = sum(sizes.get(o, 0) for o in operands) or sizes[name]
        found = _SHAPE_RE.findall(head)
        shapes = f"{len(found)} x {found[0][0]}[{found[0][1]}]" if found \
            else "?"
        key = out[f"{kind} {shapes}"]
        key[0] += nbytes * mult.get(cur, 0.0)
        key[1] += mult.get(cur, 0.0)
    return sorted(((b, n, k) for k, (b, n) in out.items()),
                  key=lambda t: -t[0])


def reference_hlo(arch: str, shape: str, mesh: str) -> str:
    """Compile the reference's dry-run cell and return its optimized HLO
    (the module forces 512 host devices on import, so this runs in a
    process of its own)."""
    import repro.launch.dryrun as ref

    seen = {}
    summarize = ref.summarize

    def keep(text):
        seen["hlo"] = text
        return summarize(text)

    ref.summarize = keep
    try:
        ref.run_cell(arch, shape, mesh == "multipod")
    finally:
        ref.summarize = summarize
    return seen["hlo"]


if __name__ == "__main__":
    sys.exit(main())
