"""The port's scenario runner and its command line against the JAX
package's (``dispersy_tpu.scenario.run``, ``tools/scenario.py``): the
same metrics rows (counters and coverage exactly; the two mean fills,
reduced in another order, within a few ulps as ``test_torch_step``'s
``same_snapshot`` holds them) and the same final state on every leaf
(tolerance 0).

The scenario is a compressed copy of ``examples/soak_all_features.json``
built here: its config at 256 peers and its events -- the delegation
chain, tracked public, sequenced and double-signed records, the dynamic
flip, the revoke, the unload of ten members and the explicit load of
five (``auto_load`` off) -- moved into 64 rounds.
"""

import dataclasses
import importlib.util
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from dispersy_tpu import scenario as jscn

from dispersy_tpu_torch import scenario as scn
from dispersy_tpu_torch.bridge import first_difference, state_to_numpy
from test_torch_ops import release_xla_executables  # noqa: F401

# One torch thread, as in test_torch_ops.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOAK = os.path.join(ROOT, "examples", "soak_all_features.json")
# The soak file's event rounds -> this copy's (its 600 rounds -> 64).
ROUND_MAP = {0: 0, 8: 6, 16: 12, 20: 14, 30: 18, 34: 20, 40: 22, 120: 30,
             200: 36, 250: 40, 260: 42, 330: 48, 500: 56}
ROUNDS = 64
FILL_KEYS = ("store_fill", "candidate_fill")


def soak_doc(n_peers=256, rounds=ROUNDS, rmap=ROUND_MAP):
    with open(SOAK) as f:
        doc = json.load(f)
    doc["config"]["n_peers"] = n_peers
    doc["rounds"] = rounds
    doc["events"] = [dict(e, round=rmap[e["round"]]) for e in doc["events"]]
    return doc


@pytest.fixture(scope="module")
def soak_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scn") / "soak64.json")
    with open(path, "w") as f:
        json.dump(soak_doc(), f)
    return path


def jax_tool():
    """``tools/scenario.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_scenario_tool", os.path.join(ROOT, "tools", "scenario.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys(), (g["round"], set(g) ^ set(w))
        for k, v in g.items():
            if k in FILL_KEYS:
                assert v == pytest.approx(w[k], rel=1e-6), (g["round"], k)
            else:
                assert v == w[k], (g["round"], k, v, w[k])


@pytest.fixture(scope="module")
def uninterrupted(soak_file, tmp_path_factory):
    """The JAX run and the port's CPU run of the soak copy, each with an
    autosave every 16 rounds into its own directory."""
    tool = jax_tool()
    jc, jsc = tool.load(soak_file)
    pc, psc = scn.load(soak_file)
    assert repr(jc) == repr(pc)
    jdir = str(tmp_path_factory.mktemp("jax_auto"))
    pdir = str(tmp_path_factory.mktemp("port_auto"))
    js, jlog = jscn.run(jc, dataclasses.replace(
        jsc, autosave_every=16, autosave_dir=jdir), jax.random.PRNGKey(0))
    ps, plog = scn.run(pc, dataclasses.replace(
        psc, autosave_every=16, autosave_dir=pdir), 0, device="cpu")
    return pc, psc, js, jlog, ps, plog, jdir, pdir


def test_run_equal_jax(uninterrupted):
    """Every metrics row and the final state; the tracked records were
    made and the unloaded members that stayed dark hold an empty
    candidate table."""
    pc, _, js, jlog, ps, plog, _, _ = uninterrupted
    same_rows(plog.rows, jlog.rows)
    assert first_difference(state_to_numpy(ps), state_to_numpy(js)) is None
    last = plog.rows[-1]
    assert {"cov_chain_record", "cov_plain_record", "cov_seq_1",
            "cov_dark_era_record", "cov_late_record"} <= set(last)
    assert last["cov_plain_record"] > 0.5
    assert bool(ps.loaded[30:35].all())


def _keep_until(src, dst, last_round):
    """A copy of an autosave directory without the snapshots after
    ``last_round`` (the run crashed there)."""
    os.makedirs(dst)
    for name in os.listdir(src):
        stem = name.split(".")[0]
        if int(stem[len(scn.AUTOSAVE_PREFIX):]) <= last_round:
            shutil.copy(os.path.join(src, name), dst)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_resume_from_autosave_bit_identical(uninterrupted, tmp_path,
                                            writer):
    """The port resumes from the round-48 autosave (past the unload at
    40; the load at 48 runs after the resume) of its own run and of the
    JAX run, and ends bit-identical to the uninterrupted runs: the final
    state and every metrics row."""
    pc, psc, js, jlog, ps, plog, jdir, pdir = uninterrupted
    crashed = str(tmp_path / "auto")
    _keep_until(pdir if writer == "port" else jdir, crashed, 48)
    rs, rlog = scn.run(pc, dataclasses.replace(
        psc, autosave_every=16, autosave_dir=crashed), 0, resume=True,
        device="cpu")
    assert first_difference(state_to_numpy(rs), state_to_numpy(ps)) is None
    if writer == "port":
        assert rlog.rows == plog.rows
    else:
        same_rows(rlog.rows, jlog.rows)


def test_cli_writes_the_same_artifact(tmp_path, monkeypatch, capsys):
    """``python -m dispersy_tpu_torch.scenario FILE --out A --device cpu``
    and ``tools/scenario.py FILE --out B`` on a small file: the same
    artifact (meta and rows) and the same printed last row."""
    doc = soak_doc(n_peers=64, rounds=12,
                   rmap={r: min(r // 50, 11) for r in ROUND_MAP})
    doc["events"] = [e for e in doc["events"] if e["type"] in (
        "create", "unload", "load") and e.get("meta", 0) == 0]
    path = str(tmp_path / "small.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    a, b = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    scn.main([path, "--out", a, "--device", "cpu"])
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr(sys, "argv", ["scenario.py", path, "--out", b])
    jax_tool().main()
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    got, want = json.load(open(a)), json.load(open(b))
    assert got["meta"] == want["meta"]
    same_rows(got["rounds"], want["rounds"])
    same_rows([json.loads(port_line)], [json.loads(jax_line)])
    assert len(got["rounds"]) == 12


def test_ring_chunks_equal_jax(tmp_path):
    """With the telemetry ring (history 8) and the trace plane on, event-
    free spans run as one ``multi_step`` and drain the ring
    (``_ring_chunk``); a tracked record's curve comes from the row's
    trace words.  The rows and the final state equal JAX's, which chunks
    the same spans, and a resume from the round-16 autosave ends
    bit-identical."""
    doc = {"config": {"n_peers": 64, "n_trackers": 2, "k_candidates": 8,
                      "msg_capacity": 32, "bloom_capacity": 16,
                      "request_inbox": 4, "tracker_inbox": 16,
                      "response_budget": 4, "churn_rate": 0.03,
                      "packet_loss": 0.1, "auto_load": False,
                      "telemetry": {"enabled": True, "history": 8},
                      "trace": {"enabled": True, "tracked_slots": 2}},
           "rounds": 30, "seed_degree": 4, "events": [
               {"round": 0, "type": "create", "meta": 1, "authors": [7],
                "payload": 11, "track": "first"},
               {"round": 5, "type": "create", "meta": 0, "authors": [20],
                "payload": 12, "track": "second"},
               {"round": 10, "type": "unload", "members": [30, 31, 32]},
               {"round": 13, "type": "create", "meta": 0,
                "authors": [40], "payload": 13},
               {"round": 18, "type": "load", "members": [30]}]}
    path = str(tmp_path / "ring.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    jc, jsc = jax_tool().load(path)
    pc, psc = scn.load(path)
    assert repr(jc) == repr(pc)
    assert scn._ring_chunk(pc, psc, {}, {}, 0) == 8
    js, jlog = jscn.run(jc, jsc, jax.random.PRNGKey(3))
    auto = str(tmp_path / "auto")
    ps, plog = scn.run(pc, dataclasses.replace(
        psc, autosave_every=16, autosave_dir=auto), 3, device="cpu")
    same_rows(plog.rows, jlog.rows)
    assert first_difference(state_to_numpy(ps), state_to_numpy(js)) is None
    assert any(k.startswith("cov_") for k in plog.rows[-1])
    rs, rlog = scn.run(pc, dataclasses.replace(
        psc, autosave_every=16, autosave_dir=auto), 3, resume=True,
        device="cpu")
    assert rlog.rows == plog.rows
    assert first_difference(state_to_numpy(rs), state_to_numpy(ps)) is None


def test_run_needs_a_card_unless_asked(soak_file):
    """``run`` on ``"cuda"`` without a card raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pc, psc = scn.load(soak_file)
    with pytest.raises(RuntimeError, match="cuda"):
        scn.run(pc, psc)
    np.testing.assert_equal(sorted(scn.EVENT_TYPES),
                            sorted(jax_tool().EVENT_TYPES))
