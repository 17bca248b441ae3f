"""The port's CFD<->DRL file interface and data pipeline against the
reference (``repro.core.interface``, ``repro.data.pipeline``).

The port carries its own msgpack encoder and decoder (the card's host has
no ``msgpack``); its bytes are held equal to the reference's
``pack_arrays`` (``msgpack.packb``) over arrays whose names, ranks, dims
and sizes cross every width boundary of the formats it writes, and each
package's ``unpack_arrays`` reads the other's bytes exactly.  The file
interface writes the reference's files byte for byte.  Everything here is
exact: the codec moves float32 bits, and the token stream is the same
numpy generator."""
import dataclasses

import msgpack
import numpy as np
import pytest
import torch

from repro.core import interface as jif
from repro.data import pipeline as jpipe
from repro.drl.ppo import Batch as JBatch
from repro_torch.core import interface as tif
from repro_torch.data import pipeline as tpipe
from repro_torch.drl.ppo import Batch


def _arrays(case, seed=0):
    """Seeded arrays crossing the codec's width boundaries: names of
    fixstr / str8 / str16 length (the ``_shape`` key crosses too), ranks
    of fixarray / array16 length, dims of positive fixint / uint8 / uint16
    / uint32 value, payloads of bin8 / bin16 / bin32 length, and a top
    map of fixmap / map16 size."""
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {
        # fixstr names, fixarray shapes of fixint dims, bin8 payloads
        "fix": {"obs": rnd(3, 5), "reward": rnd(7), "scalar0d": rnd()},
        # "x"*27 + "_shape" is 33 bytes (str8); 300-byte names are str16
        "names": {"x" * 26: rnd(2), "x" * 27: rnd(2), "y" * 300: rnd(1, 4)},
        # rank 15 stays fixarray, rank 16 and 17 are array16
        "ranks": {"r15": rnd(*(1,) * 15), "r16": rnd(*(1,) * 16),
                  "r17": rnd(*(2,) + (1,) * 16)},
        # dims 127 / 128 (uint8) / 255 / 256 (uint16) / 65536 (uint32);
        # payloads 508 B (bin16) and 262,144 B (bin32)
        "dims": {"d127": rnd(127), "d128": rnd(1, 128),
                 "d255": rnd(255, 1), "d256": rnd(256),
                 "d65536": rnd(65536), "empty": np.zeros((0, 70000),
                                                         np.float32)},
        # 1 + 2 * 8 = 17 top-level entries: map16
        "map16": {f"a{i}": rnd(i + 1) for i in range(8)},
        # float64 and int inputs are cast to float32, as the reference does
        "cast": {"f64": rng.standard_normal((4, 3)),
                 "i64": np.arange(6).reshape(2, 3)},
    }[case]


CASES = ["fix", "names", "ranks", "dims", "map16", "cast"]
SCALARS = [None, {"action": 0.25}, {"s" * 40: -1.5, "t": 3.0}]


@pytest.mark.parametrize("scalars", SCALARS, ids=["none", "one", "str8"])
@pytest.mark.parametrize("case", CASES)
def test_pack_arrays_bytes_equal_the_reference(case, scalars):
    arrays = _arrays(case)
    ours = tif.pack_arrays(arrays, scalars)
    ref = jif.pack_arrays(arrays, scalars)
    assert ours == ref


@pytest.mark.parametrize("case", CASES)
def test_unpack_reads_the_other_package_exactly(case):
    arrays = _arrays(case, seed=1)
    scalars = {"action": -0.125}
    for blob, unpack in ((jif.pack_arrays(arrays, scalars),
                          tif.unpack_arrays),
                         (tif.pack_arrays(arrays, scalars),
                          jif.unpack_arrays)):
        back, sc = unpack(blob)
        assert sc == scalars and list(back) == list(arrays)
        for k, a in arrays.items():
            # a 0-d array packs as shape [1] in both (ascontiguousarray)
            want = np.ascontiguousarray(a, np.float32)
            assert back[k].dtype == np.float32 and back[k].shape == want.shape
            np.testing.assert_array_equal(back[k], want)


# every int width, both signs, nil, bools, float64, str / bin / array / map
# lengths on each side of a boundary
OBJECTS = [None, True, False, 0, 127, 128, 255, 256, 65535, 65536,
           2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129,
           -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63, 1.5, -0.0,
           float("inf"), "", "a" * 31, "a" * 32, "é" * 200, b"",
           b"x" * 255, b"x" * 256, list(range(15)), list(range(16)),
           {str(i): [i, None, True] for i in range(15)},
           {str(i): {"k": -i} for i in range(16)}]


@pytest.mark.parametrize("obj", OBJECTS, ids=range(len(OBJECTS)))
def test_msgpack_subset_matches_msgpack(obj):
    blob = msgpack.packb(obj)
    assert tif.packb(obj) == blob
    assert tif.unpackb(blob) == msgpack.unpackb(blob)


@pytest.mark.parametrize("blob", [
    b"\xca\x3f\x80\x00\x00",          # float32: not written, not read
    b"\xc7\x01\x05\x00",              # ext8
    b"\xd4\x05\x00",                  # fixext1
    b"\xc1",                          # never used
    b"\x92\x01",                      # an array cut short
    b"\x01\x02",                      # trailing bytes
    b"\x81\x01\x02",                  # an int map key
], ids=["float32", "ext8", "fixext1", "c1", "short", "trailing", "intkey"])
def test_unpackb_refuses_what_it_does_not_read(blob):
    with pytest.raises(ValueError):
        tif.unpackb(blob)


def test_unpack_arrays_refuses_a_non_map():
    with pytest.raises(ValueError, match="not a map"):
        tif.unpack_arrays(msgpack.packb([1, 2]))


# ---------------------------------------------------------------------------
# the file interface
# ---------------------------------------------------------------------------

def _record(seed=0):
    rng = np.random.default_rng(seed)
    return dict(obs=rng.standard_normal(149),
                forces=rng.standard_normal((10, 2)), action=0.25)


@pytest.mark.parametrize("mode", tif.MODES)
def test_file_interface_roundtrip_and_files_equal_the_reference(tmp_path,
                                                                mode):
    """Every mode round-trips (the ASCII text to its 9 digits, the binary
    payload exactly as float32); every file the port writes equals the
    reference's byte for byte ('optimized_zstd' against the reference's
    'optimized': the port writes it uncompressed)."""
    ours = tif.FileInterface(mode, str(tmp_path / "t"), 0,
                             flowfield_floats=1000)
    ref_mode = "optimized" if mode == "optimized_zstd" else mode
    ref = jif.FileInterface(ref_mode, str(tmp_path / "j"), 0,
                            flowfield_floats=1000)
    rec = _record()
    ours.inject_action(rec["action"])
    ref.inject_action(rec["action"])
    nb = ours.write_actuation(3, tif.ExchangeRecord(**rec))
    assert nb == ref.write_actuation(3, jif.ExchangeRecord(**rec))
    if mode == "disabled":
        assert nb == 0 and ours.read_action() == 0.0
        assert not (tmp_path / "t").exists()
        with pytest.raises(RuntimeError, match="holds no data"):
            ours.read_actuation(3)
        return
    assert nb > 0
    back = ours.read_actuation(3)
    if mode == "file_baseline":
        np.testing.assert_allclose(back.obs, rec["obs"], rtol=1e-9)
        np.testing.assert_allclose(back.forces, rec["forces"], rtol=1e-9)
    else:
        np.testing.assert_array_equal(back.obs,
                                      rec["obs"].astype(np.float32))
        np.testing.assert_array_equal(back.forces,
                                      rec["forces"].astype(np.float32))
    assert back.action == 0.25 and ours.read_action() == 0.25
    files = sorted(p.relative_to(ours.dir) for p in ours.dir.rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(ref.dir)
                           for p in ref.dir.rglob("*") if p.is_file())
    for f in files:
        assert (ours.dir / f).read_bytes() == (ref.dir / f).read_bytes(), f
    # and the reference reads the port's files
    jback = jif.FileInterface(ref_mode, str(tmp_path / "t"), 0,
                              flowfield_floats=1000).read_actuation(3)
    np.testing.assert_array_equal(np.asarray(jback.obs), np.asarray(back.obs))
    ours.cleanup()
    assert not ours.dir.exists()


def test_action_injection_text_equals_the_reference(tmp_path):
    ours = tif.FileInterface("file_baseline", str(tmp_path / "t"), 0,
                             flowfield_floats=10)
    ref = jif.FileInterface("file_baseline", str(tmp_path / "j"), 0,
                            flowfield_floats=10)
    for a in (0.0, -1.25, 0.37281, 1e-9, -3.5e4):
        ours.inject_action(a)
        ref.inject_action(a)
        text = (ours.dir / "jetVelocity").read_text()
        assert text == (ref.dir / "jetVelocity").read_text()
        assert ours.read_action() == ref.read_action()
        assert abs(ours.read_action() - a) < 1e-7 * max(1.0, abs(a))
    # the antisymmetric jet: -a into jet2
    assert "jet2 { type fixedValue; value uniform (35000.00000000 0 0)" \
        in text


def test_unknown_mode_rejected(tmp_path):
    with pytest.raises(ValueError, match="unknown interface mode"):
        tif.FileInterface("parquet", str(tmp_path))


@pytest.mark.parametrize("mode", ["file_baseline", "optimized"])
def test_payload_sizes_match_the_reference_and_the_paper(tmp_path, mode):
    """Baseline ~5 MB an actuation, optimized ~1.2 MB (-76%), paper
    §III.D, with the default flow-field payload; equal to the reference's
    byte counts."""
    rec = dict(obs=np.zeros(149), forces=np.zeros((10, 2)), action=0.0)
    nb = tif.FileInterface(mode, str(tmp_path / "t")).write_actuation(
        0, tif.ExchangeRecord(**rec))
    assert nb == jif.FileInterface(mode, str(tmp_path / "j")).write_actuation(
        0, jif.ExchangeRecord(**rec))
    lo, hi = (4.0e6, 6.5e6) if mode == "file_baseline" else (1.0e6, 1.5e6)
    assert lo < nb < hi, nb
    assert (tif.BASELINE_FLOWFIELD_FLOATS, tif.OPTIMIZED_FLOWFIELD_FLOATS) \
        == (jif.BASELINE_FLOWFIELD_FLOATS, jif.OPTIMIZED_FLOWFIELD_FLOATS)


@pytest.mark.parametrize("mode", ["file_baseline", "optimized", "disabled"])
def test_multi_env_exchange_matches_the_reference(tmp_path, mode):
    """``exchange`` of a torch batch returns it unchanged and moves the
    reference's bytes for the same batch; the files it leaves are the
    reference's."""
    rng = np.random.default_rng(2)
    n_envs, T, P = 3, 4, 149
    obs = rng.standard_normal((n_envs * T, P)).astype(np.float32)
    act = rng.uniform(-1, 1, (n_envs * T, 1)).astype(np.float32)
    z = np.zeros(n_envs * T, np.float32)
    batch = Batch(*(torch.tensor(x) for x in (obs, act, z, z, z)))
    ours = tif.MultiEnvInterface(mode, str(tmp_path / "t"), n_envs,
                                 flowfield_floats=500)
    ref = jif.MultiEnvInterface(mode, str(tmp_path / "j"), n_envs,
                                flowfield_floats=500)
    for _ in range(2):
        assert ours.exchange(batch) is batch
        ref.exchange(JBatch(obs, act, z, z, z))
    assert ours.bytes_moved == ref.bytes_moved
    assert ours.period == ref.period == (0 if mode == "disabled" else 2)
    if mode == "disabled":
        assert ours.bytes_moved == 0 and ours.time_spent == 0.0
        return
    assert ours.bytes_moved > 0 and ours.time_spent > 0.0
    for i in range(n_envs):
        d = f"env_{i:04d}"
        for p in (tmp_path / "t" / d).rglob("*"):
            if p.is_file():
                q = tmp_path / "j" / p.relative_to(tmp_path / "t")
                assert p.read_bytes() == q.read_bytes(), p
    ours.cleanup()
    assert not any((tmp_path / "t").iterdir())


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (7, 3), (7, 4), (123, 99)])
def test_synthetic_batch_equals_the_reference(seed, step):
    cfg = dict(vocab_size=5000, seq_len=32, global_batch=4, seed=seed)
    ours = tpipe.synthetic_batch(tpipe.LMDataConfig(**cfg), step)
    ref = jpipe.synthetic_batch(jpipe.LMDataConfig(**cfg), step)
    assert sorted(ours) == sorted(ref) == ["labels", "tokens"]
    for k in ours:
        assert ours[k].dtype == ref[k].dtype == np.int32
        np.testing.assert_array_equal(ours[k], ref[k])
    assert (ours["labels"][:, :-1] == ours["tokens"][:, 1:]).all()
    assert 0 <= ours["tokens"].min() and ours["tokens"].max() < 5000


def test_lm_iterator_steps_and_frontend_refusal():
    """The iterator's batches from ``start_step`` on; with a frontend
    config (the vision one, once refused here) each batch also holds the
    patch embeddings drawn after the tokens, bit-equal to the
    reference's."""
    cfg = tpipe.LMDataConfig(vocab_size=100, seq_len=8, global_batch=2,
                             seed=1)
    it = tpipe.lm_iterator(cfg, start_step=5)
    for step in (5, 6, 7):
        np.testing.assert_array_equal(
            next(it)["tokens"],
            jpipe.synthetic_batch(jpipe.LMDataConfig(
                vocab_size=100, seq_len=8, global_batch=2, seed=1),
                step)["tokens"])
    from repro.configs.base import get_config as jget
    from repro_torch.configs.base import get_config
    vision = dataclasses.replace(get_config("phi4-mini-3.8b"),
                                 frontend="vision")
    jvision = dataclasses.replace(jget("phi4-mini-3.8b"), frontend="vision")
    it = tpipe.lm_iterator(cfg, vision, start_step=2)
    for step in (2, 3):
        ours = next(it)
        ref = jpipe.synthetic_batch(jpipe.LMDataConfig(
            vocab_size=100, seq_len=8, global_batch=2, seed=1), step, jvision)
        assert sorted(ours) == sorted(ref) == ["frontend_embeds", "labels",
                                               "tokens"]
        assert ours["frontend_embeds"].shape == (2, 8, 1280)
        for k in ours:
            assert ours[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(ours[k], ref[k])


def test_trajectory_store_evicts_and_concatenates_as_the_reference():
    """``add`` keeps the newest ``capacity`` batches; ``sample_all``
    concatenates them field by field on their device (None fields stay
    None), equal to the reference store fed the same batches."""
    rng = np.random.default_rng(4)
    ours = tpipe.TrajectoryStore(capacity_episodes=2)
    ref = jpipe.TrajectoryStore(capacity_episodes=2)
    for ep in range(3):
        fields = [rng.standard_normal((5, 3)).astype(np.float32),
                  rng.standard_normal((5, 1)).astype(np.float32)] + [
            rng.standard_normal(5).astype(np.float32) for _ in range(3)]
        ours.add(Batch(*(torch.tensor(x) for x in fields)))
        ref.add(JBatch(*fields))
        if ep == 0:
            single = ours.sample_all()
            assert single.obs.shape == (5, 3)
    assert len(ours) == len(ref) == 2
    got, want = ours.sample_all(), ref.sample_all()
    assert isinstance(got, Batch) and got.valid is None
    for f in ("obs", "act", "logp_old", "adv", "ret"):
        assert getattr(got, f).shape[0] == 10
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    d = tpipe.TrajectoryStore(3)
    for i in range(2):
        d.add({"x": torch.full((2,), float(i)), "y": None})
    out = d.sample_all()
    assert out["y"] is None and out["x"].tolist() == [0.0, 0.0, 1.0, 1.0]
