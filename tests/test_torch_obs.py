"""The port's trace exports and profile report against the reference's.

The same event list goes through both packages' writers: the JSONL and
Chrome-trace files must be byte-equal, and both packages must read either
back to the same events and render the same profile.  On the CPU.
"""
import json

import pytest

from repro.core.einsum import einsum_to_dict
from repro.core.mapper import tcm_map as ref_tcm_map
from repro.core.presets import small_matmul_suite, tpu_v4i_like
from repro.obs import Tracer as RefTracer
from repro.obs import profile as ref_profile
from repro.obs import read_trace as ref_read_trace
from repro.obs import write_chrome as ref_write_chrome
from repro.obs import write_jsonl as ref_write_jsonl
import repro_torch.core as P
from repro_torch.core.presets import tpu_v4i_like as port_tpu_v4i_like
from repro_torch.obs import (Tracer, from_chrome, profile, read_jsonl,
                             read_trace, to_chrome, write_chrome,
                             write_jsonl)
from repro_torch.obs.__main__ import main as obs_main

WRITERS = {"jsonl": (write_jsonl, ref_write_jsonl),
           "chrome": (write_chrome, ref_write_chrome)}


@pytest.fixture(scope="module")
def events():
    tr = RefTracer()
    ref_tcm_map(small_matmul_suite()["P0"], tpu_v4i_like(), tracer=tr)
    return tr.events


@pytest.mark.parametrize("fmt", sorted(WRITERS))
def test_exports_byte_equal_to_reference(tmp_path, events, fmt):
    port_write, ref_write = WRITERS[fmt]
    suffix = ".jsonl" if fmt == "jsonl" else ".json"
    port_write(events, tmp_path / f"port{suffix}")
    ref_write(events, tmp_path / f"ref{suffix}")
    assert (tmp_path / f"port{suffix}").read_bytes() == \
        (tmp_path / f"ref{suffix}").read_bytes()
    assert read_trace(tmp_path / f"ref{suffix}") == \
        ref_read_trace(tmp_path / f"port{suffix}")


def test_chrome_roundtrip(events):
    doc = to_chrome(events)
    assert doc["otherData"]["producer"] == "repro.obs"  # the shared format
    back = from_chrome(doc)
    assert len(back) == len(events)
    for a, b in zip(back, sorted(events, key=lambda e: e["ts"])):
        assert a["name"] == b["name"] and a["cat"] == b["cat"]
        assert a["ts"] == pytest.approx(b["ts"], abs=1e-5)


def test_profile_renders_as_the_reference(events):
    assert profile(events).render(top_k=3) == \
        ref_profile(events).render(top_k=3)


def test_port_trace_attributes_every_prune():
    tr = Tracer()
    ein = P.einsum_from_dict(einsum_to_dict(small_matmul_suite()["P0"]))
    _, st = P.tcm_map(ein, port_tpu_v4i_like(), tracer=tr)
    rep = profile(tr.events)
    assert rep.n_events == len(tr.events)
    assert rep.prune.expanded == st.n_expanded
    assert rep.prune.pruned_total == (st.n_pruned_dominated
                                      + st.n_pruned_bound
                                      + st.n_pruned_invalid)
    assert "prune attribution" in rep.render(top_k=3)


def test_tracer_save_picks_format(tmp_path):
    tr = Tracer()
    tr.instant("x")
    tr.save(tmp_path / "a.jsonl")
    tr.save(tmp_path / "a.json")
    assert (tmp_path / "a.jsonl").read_text().startswith('{"ph":"i"')
    assert json.loads((tmp_path / "a.json").read_text())["traceEvents"]


def test_obs_cli(tmp_path, events, capsys):
    src = tmp_path / "t.jsonl"
    write_jsonl(events, src)
    assert obs_main(["report", str(src), "--top", "2"]) == 0
    assert "phase breakdown" in capsys.readouterr().out
    assert obs_main([str(src)]) == 0  # bare path implies report
    assert "phase breakdown" in capsys.readouterr().out
    chrome = tmp_path / "t.json"
    assert obs_main(["chrome", str(src), "-o", str(chrome)]) == 0
    assert len(from_chrome(json.loads(chrome.read_text()))) == len(events)
    jl = tmp_path / "back.jsonl"
    assert obs_main(["jsonl", str(chrome), "-o", str(jl)]) == 0
    assert len(read_jsonl(jl)) == len(events)


def test_netmap_cli_trace_reads_in_obs_report(tmp_path, capsys):
    from repro_torch.netmap.__main__ import main as netmap_main

    trace = tmp_path / "net.jsonl"
    assert netmap_main(["--config", "qwen1_5_0_5b", "--fast", "--no-fuse",
                        "--cache-dir", str(tmp_path / "c"),
                        "--trace", str(trace)]) == 0
    capsys.readouterr()
    cats = {e["cat"] for e in read_jsonl(trace)}
    assert {"cache", "driver"} <= cats
    assert obs_main([str(trace)]) == 0
    assert "phase breakdown" in capsys.readouterr().out
