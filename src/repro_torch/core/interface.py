"""CFD <-> DRL data interface: the paper's I/O bottleneck, reproduced.

Port of ``repro.core.interface``.  DRLinFluids couples OpenFOAM and
TensorForce through the file system: every actuation period each
environment dumps probe / force / flow-field files, Python parses them, and
actions are injected back into text config files by regex.  The paper
shows this interface throttles >30-env training and fixes it with two
measures: drop non-essential flow-field dumps and use binary formats
(5.0 MB -> 1.2 MB per actuation).

Modes (all with real file I/O):

  'file_baseline'  ASCII dumps (OpenFOAM-style), the full synthetic
                   flow-field payload, regex action injection into a
                   config file.
  'optimized'      one binary file (msgpack header + raw float32), the
                   essential arrays only.
  'optimized_zstd' accepted for the reference's configurations; this
                   package carries no zstd codec, so it writes the
                   'optimized' payload uncompressed, as the reference does
                   where zstandard is not installed.
  'disabled'       no-op (the paper's upper bound).

The binary codec (``pack_arrays`` / ``unpack_arrays``) is also the payload
of the trajectory sinks and of the trajectory dataset.  It encodes the
subset of msgpack the reference emits with its own encoder, byte for byte
what ``msgpack.packb`` gives for the same dict, so a file written by
either package reads in the other; the ``msgpack`` package itself is not
needed.
"""
from __future__ import annotations

import re
import shutil
import struct
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

MODES = ("file_baseline", "optimized", "optimized_zstd", "disabled")


# ---------------------------------------------------------------------------
# msgpack subset: maps with str keys, bin, str, arrays, ints, float64, nil
# and bool (the msgpack spec's formats, ``use_bin_type`` semantics)
# ---------------------------------------------------------------------------

def _pack_len(out: bytearray, n: int, fix: Optional[Tuple[int, int]],
              codes: Tuple[Tuple[int, int], ...], what: str) -> None:
    """A container or string header: the fix form ``(base, limit)`` when
    ``n`` fits it, else the first of ``codes`` ((code, width in bytes))
    wide enough."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
        return
    for code, width in codes:
        if n < 1 << (8 * width):
            out.append(code)
            out += n.to_bytes(width, "big")
            return
    raise ValueError(f"msgpack {what} of length {n} is too long")


def _pack_int(out: bytearray, x: int) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif x >= 0:
        for code, width in ((0xcc, 1), (0xcd, 2), (0xce, 4), (0xcf, 8)):
            if x < 1 << (8 * width):
                out.append(code)
                out += x.to_bytes(width, "big")
                return
        raise ValueError(f"integer {x} does not fit msgpack's uint64")
    elif x >= -32:
        out.append(x & 0xff)
    else:
        for code, width in ((0xd0, 1), (0xd1, 2), (0xd2, 4), (0xd3, 8)):
            if x >= -(1 << (8 * width - 1)):
                out.append(code)
                out += x.to_bytes(width, "big", signed=True)
                return
        raise ValueError(f"integer {x} does not fit msgpack's int64")


def _pack(out: bytearray, x) -> None:
    if x is None:
        out.append(0xc0)
    elif x is True or x is False:
        out.append(0xc3 if x else 0xc2)
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out.append(0xcb)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        _pack_len(out, len(raw), (0xa0, 32),
                  ((0xd9, 1), (0xda, 2), (0xdb, 4)), "str")
        out += raw
    elif isinstance(x, (bytes, bytearray, memoryview)):
        raw = memoryview(x).cast("B")
        _pack_len(out, raw.nbytes, None, ((0xc4, 1), (0xc5, 2), (0xc6, 4)),
                  "bin")
        out += raw
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), (0x90, 16), ((0xdc, 2), (0xdd, 4)), "array")
        for v in x:
            _pack(out, v)
    elif isinstance(x, dict):
        _pack_len(out, len(x), (0x80, 16), ((0xde, 2), (0xdf, 4)), "map")
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot msgpack-encode {type(x).__name__}")


def packb(obj) -> bytes:
    """msgpack-encode ``obj`` (dicts, lists, str, bytes, int, float, bool,
    None): the bytes ``msgpack.packb(obj)`` gives."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    def __init__(self, blob):
        self.buf = memoryview(blob).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack data ends at byte {len(self.buf)}, "
                             f"wanted {n} more at byte {self.pos}")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def uint(self, width: int) -> int:
        return int.from_bytes(self.take(width), "big")

    def obj(self):
        c = self.uint(1)
        if c < 0x80:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self.map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return [self.obj() for _ in range(c & 0x0f)]
        if 0xa0 <= c <= 0xbf:
            return self.text(c & 0x1f)
        if c == 0xc0:
            return None
        if c in (0xc2, 0xc3):
            return c == 0xc3
        if c in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(self.uint(1 << (c - 0xc4))))
        if c == 0xcb:
            return struct.unpack(">d", self.take(8))[0]
        if 0xcc <= c <= 0xcf:
            return self.uint(1 << (c - 0xcc))
        if 0xd0 <= c <= 0xd3:
            return int.from_bytes(self.take(1 << (c - 0xd0)), "big",
                                  signed=True)
        if c in (0xd9, 0xda, 0xdb):
            return self.text(self.uint(1 << (c - 0xd9)))
        if c in (0xdc, 0xdd):
            return [self.obj() for _ in range(self.uint(2 if c == 0xdc
                                                        else 4))]
        if c in (0xde, 0xdf):
            return self.map(self.uint(2 if c == 0xde else 4))
        raise ValueError(f"msgpack format byte {c:#04x} at byte "
                         f"{self.pos - 1} is not one this codec reads")

    def text(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"msgpack map key {k!r} is not a string")
            out[k] = self.obj()
        return out


def unpackb(blob) -> object:
    """Decode one msgpack object (the formats ``packb`` writes, plus every
    int, negative-int, nil and bool form); raises ``ValueError`` on any
    other format or on trailing bytes."""
    r = _Reader(blob)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} trailing bytes after the "
                         f"msgpack object")
    return out


# ---------------------------------------------------------------------------
# binary codec (shared by FileInterface and the trajectory sinks)
# ---------------------------------------------------------------------------

def pack_arrays(arrays: Dict[str, np.ndarray],
                scalars: Optional[Dict[str, float]] = None) -> bytes:
    """msgpack + raw fp32 payload: ``{"__scalars__": {...}, name: bytes,
    name_shape: [...]}``, arrays in the order given."""
    payload: Dict[str, object] = {"__scalars__": dict(scalars or {})}
    for name, arr in arrays.items():
        a = np.ascontiguousarray(np.asarray(arr), dtype=np.float32)
        payload[name] = a.tobytes()
        payload[name + "_shape"] = list(a.shape)
    return packb(payload)


def unpack_arrays(blob: bytes):
    """Inverse of ``pack_arrays`` -> (arrays dict, scalars dict)."""
    d = unpackb(blob)
    if not isinstance(d, dict):
        raise ValueError(f"not a pack_arrays payload: a msgpack "
                         f"{type(d).__name__}, not a map")
    scalars = d.pop("__scalars__", {})
    arrays = {}
    for name, raw in d.items():
        if name.endswith("_shape"):
            continue
        arrays[name] = np.frombuffer(raw, np.float32).reshape(
            d[name + "_shape"])
    return arrays, scalars


# Paper: "multiple files with a total size of 5.0 MB ... at the end of each
# instance of CFD simulation"; optimized: 1.2 MB (-76%).
BASELINE_FLOWFIELD_FLOATS = 5_000_000 // 13  # ~5.0 MB as "%.6e" ascii text
OPTIMIZED_FLOWFIELD_FLOATS = 1_200_000 // 4  # ~1.2 MB binary fp32


@dataclass
class ExchangeRecord:
    obs: np.ndarray          # (149,) probe pressures
    forces: np.ndarray       # (T_hist, 2) CD/CL history for reward
    action: float
    flow_field: Optional[np.ndarray] = None   # the redundant payload


class FileInterface:
    """One instance per environment (mirrors one OpenFOAM case directory)."""

    def __init__(self, mode: str, root: str, env_id: int = 0,
                 flowfield_floats: Optional[int] = None):
        if mode not in MODES:
            raise ValueError(f"unknown interface mode {mode!r}; choose from "
                             f"{MODES}")
        self.mode = mode
        self.env_id = env_id
        self.dir = Path(root) / f"env_{env_id:04d}"
        if mode != "disabled":
            self.dir.mkdir(parents=True, exist_ok=True)
            self._write_config_template()
        if flowfield_floats is None:
            flowfield_floats = (BASELINE_FLOWFIELD_FLOATS
                                if mode == "file_baseline"
                                else OPTIMIZED_FLOWFIELD_FLOATS)
        self.flowfield_floats = flowfield_floats

    # -- OpenFOAM-style config with regex action injection -------------------

    def _write_config_template(self):
        (self.dir / "jetVelocity").write_text(
            "/* OpenFOAM-style boundary dictionary */\n"
            "boundaryField\n{\n"
            "    jet1 { type fixedValue; value uniform (0.0 0 0); }\n"
            "    jet2 { type fixedValue; value uniform (0.0 0 0); }\n"
            "}\n")

    _JET_RE = re.compile(r"(jet([12]) \{ type fixedValue; value uniform \()"
                         r"[-0-9.eE+]+")

    def inject_action(self, action: float) -> None:
        """Regex-rewrite the config file (the paper's action path)."""
        if self.mode == "disabled":
            return
        path = self.dir / "jetVelocity"
        text = path.read_text()

        def sub(m):
            sign = 1.0 if m.group(2) == "1" else -1.0
            return f"{m.group(1)}{sign * action:.8f}"

        path.write_text(self._JET_RE.sub(sub, text))

    def read_action(self) -> float:
        if self.mode == "disabled":
            return 0.0
        text = (self.dir / "jetVelocity").read_text()
        m = self._JET_RE.search(text)
        return float(m.group(0).rsplit("(", 1)[-1])

    # -- per-actuation state dump / load -------------------------------------

    def write_actuation(self, period: int, rec: ExchangeRecord) -> int:
        """Write one actuation period's data.  Returns bytes written."""
        if self.mode == "disabled":
            return 0
        if self.mode == "file_baseline":
            return self._write_ascii(period, rec)
        return self._write_binary(period, rec)

    def read_actuation(self, period: int) -> ExchangeRecord:
        if self.mode == "disabled":
            raise RuntimeError("disabled interface holds no data")
        if self.mode == "file_baseline":
            return self._read_ascii(period)
        return self._read_binary(period)

    # ascii (OpenFOAM-ish): one file per field, textual numbers ------------

    def _write_ascii(self, period: int, rec: ExchangeRecord) -> int:
        n = 0
        d = self.dir / f"{period:06d}"
        d.mkdir(exist_ok=True)
        for name, arr in (("p_probes", rec.obs), ("forces", rec.forces)):
            body = "\n".join(" ".join(f"{x:.9e}" for x in np.atleast_1d(row))
                             for row in np.atleast_2d(arr))
            txt = f"// field {name}\n{body}\n"
            (d / name).write_text(txt)
            n += len(txt)
        ff = rec.flow_field
        if ff is None:
            ff = np.zeros(self.flowfield_floats, np.float64)
        # OpenFOAM writes full fields in ascii by default: the redundant dump
        body = "\n".join(f"{x:.6e}" for x in ff[: self.flowfield_floats])
        txt = f"// flowField\n{body}\n"
        (d / "flowField").write_text(txt)
        n += len(txt)
        return n

    def _read_ascii(self, period: int) -> ExchangeRecord:
        d = self.dir / f"{period:06d}"

        def parse(name):
            lines = (d / name).read_text().splitlines()[1:]
            return np.array([[float(x) for x in ln.split()]
                             for ln in lines if ln])

        obs = parse("p_probes").ravel()
        forces = parse("forces")
        _ = (d / "flowField").read_text()          # parsed (cost) but unused
        return ExchangeRecord(obs=obs, forces=forces,
                              action=self.read_action())

    # binary (optimized): one msgpack+raw file, essential arrays only -------

    def _write_binary(self, period: int, rec: ExchangeRecord) -> int:
        arrays = {"obs": rec.obs,
                  "forces": np.atleast_2d(np.asarray(rec.forces))}
        if self.flowfield_floats:
            ff = rec.flow_field
            if ff is None:
                ff = np.zeros(self.flowfield_floats, np.float32)
            arrays["flow"] = np.asarray(ff)[: self.flowfield_floats]
        blob = pack_arrays(arrays, scalars={"action": float(rec.action)})
        path = self.dir / f"{period:06d}.bin"
        path.write_bytes(blob)
        return len(blob)

    def _read_binary(self, period: int) -> ExchangeRecord:
        blob = (self.dir / f"{period:06d}.bin").read_bytes()
        arrays, scalars = unpack_arrays(blob)
        return ExchangeRecord(obs=arrays["obs"], forces=arrays["forces"],
                              action=scalars["action"])

    def cleanup(self):
        if self.dir.exists():
            shutil.rmtree(self.dir, ignore_errors=True)


class MultiEnvInterface:
    """The training-loop hook: routes a whole env batch through the files,
    as DRLinFluids does once per actuation period per env."""

    def __init__(self, mode: str, root: str, n_envs: int,
                 flowfield_floats: Optional[int] = None):
        self.mode = mode
        self.envs = [FileInterface(mode, root, i, flowfield_floats)
                     for i in range(n_envs)]
        self.period = 0
        self.bytes_moved = 0
        self.time_spent = 0.0

    def exchange(self, batch):
        """Round-trip the PPO batch (``obs`` (N*T, obs_dim) env-major,
        ``act``) through the interface: one device-to-host copy each of
        ``obs`` and ``act``, then every env's write and read back.  Returns
        ``batch`` unchanged."""
        if self.mode == "disabled":
            return batch
        t0 = time.perf_counter()
        obs = batch.obs.detach().cpu().numpy()
        n = len(self.envs)
        per_env = obs.reshape(n, -1, obs.shape[-1])
        acts = batch.act.detach().cpu().numpy().reshape(n, -1)
        for i, fi in enumerate(self.envs):
            rec = ExchangeRecord(obs=per_env[i].ravel(),
                                 forces=np.zeros((10, 2), np.float32),
                                 action=float(acts[i, 0]))
            fi.inject_action(rec.action)
            self.bytes_moved += fi.write_actuation(self.period, rec)
            fi.read_actuation(self.period)
        self.period += 1
        self.time_spent += time.perf_counter() - t0
        return batch

    def cleanup(self):
        for fi in self.envs:
            fi.cleanup()
