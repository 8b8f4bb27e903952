"""The port's single-file checkpoints against the JAX package's: an archive
written by either package restores in the other, leaf for leaf
(tolerance 0), and both restored states step on equal to the source; the
port's own round trip; the corrupt-archive, version, v7 and fleet cases
as the JAX package handles them.

Two configs, each compiled once on the JAX side: the three-block
community of ``test_torch_communities`` (the Timeline, the pen, a
double-signed meta, churn and loss: bool, u8, u32, int32 and f32 leaves,
plane-sized auth and signature leaves) and ``profiling.bench_config(128)``
(the byte-diet store with u16 aux and candidate stamps and 4 cohorts).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispersy_tpu import checkpoint as jckpt
from dispersy_tpu import engine as jeng
from dispersy_tpu import state as jstate

from dispersy_tpu_torch import CheckpointError, engine, profiling
from dispersy_tpu_torch import checkpoint as ckpt
from dispersy_tpu_torch.bridge import first_difference, state_to_numpy
from dispersy_tpu_torch.config import EMPTY_META, EMPTY_U32
from test_torch_chaos import to_jax
from test_torch_communities import CFG as COMM_CFG
from test_torch_ops import ref, release_xla_executables  # noqa: F401

# One torch thread, as in test_torch_ops.
torch.set_num_threads(1)

CONFIGS = {"communities": COMM_CFG, "diet": profiling.bench_config(128)}


def diff(a, b):
    return first_difference(state_to_numpy(a), state_to_numpy(b))


def step_both(ps, pc, js, jc, rounds):
    """Step both packages ``rounds`` rounds, equal after each."""
    for rnd in range(rounds):
        js, ps = jeng.step(js, jc), engine.step(ps, pc)
        assert diff(ps, js) is None, f"round {rnd}: {diff(ps, js)}"
    return ps, js


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request, tmp_path_factory):
    """(name, port config, JAX config, JAX state after a seeded overlay,
    a post by every 8th peer and 4 rounds, the JAX archive of it)."""
    pc = CONFIGS[request.param]
    jc = to_jax(pc)
    assert repr(jc) == repr(pc)
    n = pc.n_peers
    js = ref(lambda key: jeng.seed_overlay(jstate.init_state(jc, key), jc,
                                           degree=4),
             jax.random.PRNGKey(7))
    js = jeng.create_messages_jit(js, jc, jnp.arange(n) % 8 == 3, 0,
                                  jnp.arange(n, dtype=jnp.uint32))
    for _ in range(4):
        js = jeng.step(js, jc)
    path = str(tmp_path_factory.mktemp(request.param) / "jax.npz")
    jckpt.save(path, js, jc)
    return request.param, pc, jc, js, path


@pytest.mark.parametrize("fresh", [False, True], ids=["plain", "fresh"])
def test_jax_archive_restores_in_port(case, fresh):
    """Equal to JAX's own restore (``fresh_candidates`` wipes the same
    instance memory and sets ``loaded`` by ``auto_load``), then 3 equal
    rounds."""
    _, pc, jc, js, path = case
    ps = ckpt.restore(path, pc, fresh_candidates=fresh, device="cpu")
    jr = jckpt.restore(path, jc, fresh_candidates=fresh)
    assert diff(ps, jr) is None, diff(ps, jr)
    if not fresh:
        assert diff(ps, js) is None
    step_both(ps, pc, jr, jc, 3)


def test_port_archive_restores_in_jax(case, tmp_path):
    """A port state one round past the JAX archive, saved by the port,
    restores in JAX equal to the port's state; both step 3 rounds on
    equal."""
    _, pc, jc, js, path = case
    ps = engine.step(ckpt.restore(path, pc, device="cpu"), pc)
    out = str(tmp_path / "port.npz")
    ckpt.save(out, ps, pc)
    jr = jckpt.restore(out, jc)
    assert diff(ps, jr) is None, diff(ps, jr)
    step_both(ps, pc, jr, jc, 3)


def test_port_round_trip_matches_jax_archive(case, tmp_path):
    """The port's save and restore round-trip every leaf; its archive
    holds the JAX archive's keys, dtypes, shapes and CRCs for the same
    state, and nothing is left behind but the archive."""
    _, pc, jc, js, path = case
    ps = ckpt.restore(path, pc, device="cpu")
    out = str(tmp_path / "port.npz")
    ckpt.save(out, ps, pc)
    assert diff(ckpt.restore(out, pc, device="cpu"), ps) is None
    with np.load(out) as zp, np.load(path) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zj.files:
            assert zp[k].dtype == zj[k].dtype and zp[k].shape == zj[
                k].shape, k
            if k.startswith("crc:") or k.startswith("meta:"):
                np.testing.assert_array_equal(zp[k], zj[k])
        assert zp["leaf:key"].dtype == np.uint32 and zp[
            "leaf:key"].shape == (2,)
    assert os.listdir(tmp_path) == ["port.npz"]
    assert sorted(ckpt.leaf_manifest(pc).items()) == sorted(
        jckpt.leaf_manifest(jc).items())


def _rewrite(src, dst, edit):
    with np.load(src) as z:
        arrays = {k: z[k] for k in z.files}
    edit(arrays)
    np.savez_compressed(dst, **arrays)


def _flip_byte(src, dst):
    data = bytearray(open(src, "rb").read())
    data[len(data) // 3] ^= 0x40
    open(dst, "wb").write(bytes(data))


def _torn(src, dst):
    data = open(src, "rb").read()
    open(dst, "wb").write(data[:len(data) // 2])


def _crc_mismatch(src, dst):
    def edit(a):
        a["leaf:global_time"] = a["leaf:global_time"] + np.uint32(1)
    _rewrite(src, dst, edit)


def _version(src, dst):
    def edit(a):
        a["meta:version"] = np.asarray(6)
    _rewrite(src, dst, edit)


CORRUPT = {"flipped_byte": _flip_byte, "torn": _torn,
           "crc_mismatch": _crc_mismatch, "unknown_version": _version}


@pytest.mark.parametrize("kind", sorted(CORRUPT) + ["config_mismatch"])
def test_corrupt_archives_raise(case, tmp_path, kind):
    """Each raises ``CheckpointError`` (a ``ValueError``) in the port as in
    JAX."""
    _, pc, jc, _, path = case
    bad = str(tmp_path / "bad.npz")
    if kind == "config_mismatch":
        bad, pc, jc = path, pc.replace(churn_rate=0.06), jc.replace(
            churn_rate=0.06)
    else:
        CORRUPT[kind](path, bad)
    with pytest.raises(jckpt.CheckpointError):
        jckpt.restore(bad, jc)
    with pytest.raises(CheckpointError) as e:
        ckpt.restore(bad, pc, device="cpu")
    assert isinstance(e.value, ValueError)


def _as_v7(src, dst, pc):
    """A v17 archive rewritten as its v7 twin (``tests/test_checkpoint.py``
    builds one so): no CRCs, no leaf introduced since, the four narrowed
    columns widened back to u32, the v7 fingerprint."""
    new = set().union(*ckpt._NEW_BY_VERSION.values())

    def edit(a):
        for k in list(a):
            if k.startswith("crc:") or k[len("leaf:"):] in new:
                del a[k]
        a["meta:version"] = np.asarray(7)
        a["meta:config"] = np.frombuffer(
            ckpt._want_fingerprint(pc, 7).encode(), dtype=np.uint8)
        for name in ("store_meta", "fwd_meta", "dly_meta"):
            a8 = a[f"leaf:{name}"]
            wide = a8.astype(np.uint32)
            wide[a8 == EMPTY_META] = EMPTY_U32
            a[f"leaf:{name}"] = wide
        a["leaf:store_flags"] = a["leaf:store_flags"].astype(np.uint32)
    _rewrite(src, dst, edit)


def test_v7_archive_loads_equal_to_its_v17_twin(tmp_path):
    """The three-block community (every plane at its default): the v7
    twin restores equal to the v17 archive in the port and in JAX, and
    steps on equal."""
    pc = COMM_CFG
    jc = to_jax(pc)
    assert ckpt._want_fingerprint(pc, 7) == jckpt._want_fingerprint(jc, 7)
    for v in (9, 12, 14, 16):
        assert ckpt._want_fingerprint(pc, v) == jckpt._want_fingerprint(
            jc, v)
    js = ref(lambda key: jeng.seed_overlay(jstate.init_state(jc, key), jc,
                                           degree=4),
             jax.random.PRNGKey(2))
    js = jeng.step(js, jc)
    v17, v7 = str(tmp_path / "v17.npz"), str(tmp_path / "v7.npz")
    jckpt.save(v17, js, jc)
    _as_v7(v17, v7, pc)
    p7 = ckpt.restore(v7, pc, device="cpu")
    assert p7.store_meta.dtype == torch.uint8
    assert diff(p7, ckpt.restore(v17, pc, device="cpu")) is None
    assert diff(p7, jckpt.restore(v7, jc)) is None
    step_both(p7, pc, js, jc, 1)


def test_fleet_archive_refused(tmp_path):
    pc = COMM_CFG
    jc = to_jax(pc)
    s = jstate.init_state(jc, jax.random.PRNGKey(0))
    path = str(tmp_path / "fleet.npz")
    jckpt.save_fleet(path, jstate.stack_states([s, s]), jc)
    with pytest.raises(CheckpointError, match="FLEET"):
        ckpt.restore(path, pc, device="cpu")


def test_repr_equal_across_packages():
    """The fingerprint is ``repr(cfg)``: equal in both packages for every
    config the port's tests and main paths use."""
    cfgs = [ckpt.CommunityConfig(), *CONFIGS.values(),
            profiling.communities_config(1_000_000),
            profiling.soak_config(512), profiling.chaos_config(256),
            profiling.observed_config(256)]
    for pc in cfgs:
        assert repr(to_jax(pc)) == repr(pc)


def test_stale_tmp_swept_and_cuda_needs_a_card(tmp_path):
    """A dead saver's temporary file goes with the next save; restoring
    onto ``"cuda"`` without a card raises rather than falling back."""
    pc = COMM_CFG
    path = str(tmp_path / "a.npz")
    stale = f"{path}.tmp.999999999"
    open(stale, "wb").write(b"torn")
    st = engine.seed_overlay(ckpt.init_state(pc, 1, device="cpu"), pc, 4)
    ckpt.save(path, st, pc)
    assert os.listdir(tmp_path) == ["a.npz"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ckpt.restore(path, pc)
