"""Chunked WKV6 recurrence (RWKV-6 linear attention).

Port of ``repro.kernels.rwkv6`` (``kernel.wkv6_bhsn`` and the ``ops.wkv6``
wrapper).  :func:`wkv6` takes the models' layout, ``r, k, v, w (B, S, H,
N)``, ``u (H, N)``, ``state (B, H, N, N)``, and casts ``w`` and ``u`` to
``r``'s dtype as the reference wrapper does (in bfloat16 that rounds the
decay).  On CUDA tensors it is the hand-written kernel ``csrc/wkv6.cu``,
two launches (:func:`chunk_pass`, :func:`state_pass`); on CPU tensors the plain twin :func:`wkv6_plain`, the
sequential :func:`wkv6_scan` (the reference's ``ref.wkv6_ref``).  The
output has ``r``'s dtype, the final state is float32.

The kernel is built for head sizes that are multiples of 16 up to 192 and
chunks of at most 32 tokens; the wrapper serves every head size up to 192
by zero padding (:func:`pad_heads`) and any ``chunk`` by running the
largest chunk of at most 32 that divides S (the chunk is a tiling of the
same recurrence).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

CHUNK = 32
# csrc/wkv6.cu: the head sizes it is built for (WKV6_HEAD_SIZES: the
# multiples of 16 whose state-pass block fits shared memory), and the value
# columns of the state one block owns
HEAD_SIZES = tuple(range(16, 193, 16))
COLUMNS_PER_BLOCK = 16


def kernel_head_size(N: int) -> int:
    """The head size the kernel runs a head of ``N`` at: the smallest of
    :data:`HEAD_SIZES` that holds it; ``ValueError`` over 192 (the
    state-pass block of a larger head does not fit shared memory)."""
    for n in HEAD_SIZES:
        if n >= N:
            return n
    raise ValueError(f"wkv6_cuda serves head sizes up to {HEAD_SIZES[-1]} "
                     f"(the kernel's head sizes {HEAD_SIZES}), got {N}")


def pad_heads(r, k, v, w, u, state, n: int):
    """The inputs of a WKV6 call with head size N zero-padded to ``n``:
    r, k, v, u and the state with zeros, the decay w with ones.  The padded
    rows and columns of the state then stay 0 (S = w S + k^T v with k and v
    0 there) and add exact zeros to every real output and state entry.  A
    decay padded with 0 would be clamped to 1e-30 in the chunked algebra,
    whose exp(-cumulative log-decay) overflows within two tokens, and 0
    times inf is NaN.  Slice the results back with :func:`unpad_heads`."""
    N = r.shape[-1]
    if n == N:
        return r, k, v, w, u, state
    pad = n - N

    def cols(t, value=0.0):
        return torch.nn.functional.pad(t, (0, pad), value=value)

    return (cols(r), cols(k), cols(v), cols(w, 1.0), cols(u),
            torch.nn.functional.pad(state, (0, pad, 0, pad)))


def unpad_heads(out, state, N: int):
    """The results of a padded call (:func:`pad_heads`) for head size
    ``N``."""
    if out.shape[-1] == N:
        return out, state
    return (out[..., :N].contiguous(),
            state[..., :N, :N].contiguous())


def pick_chunk(S: int, chunk: int = CHUNK) -> int:
    """The reference's chunk: ``min(chunk, S)``, decremented until it
    divides ``S``."""
    c = min(chunk, S)
    while S % c:
        c -= 1
    return c


def grid_blocks(B: int, H: int, N: int) -> int:
    """Blocks of the kernel's state pass for heads of ``N``: one per
    (batch, head, group of ``COLUMNS_PER_BLOCK`` value columns of the
    state padded to :func:`kernel_head_size`).  (Its chunk pass runs one
    block per (batch, head, chunk).)"""
    return B * H * (kernel_head_size(N) // COLUMNS_PER_BLOCK)


def scratch_floats(B: int, S: int, H: int, N: int, C: int) -> int:
    """float32 scratch the chunk pass hands the state pass, per (batch,
    head, chunk): r~ (``CHUNK`` rows of N + 4), the chunk's own output y
    (``CHUNK`` x N), its state increment k~^T v (N x N) and its decay."""
    return (CHUNK * (N + 4) + (CHUNK + N) * N + N) * B * H * (S // C)


def wkv6_scan(r, k, v, w, u, state):
    """The sequential recurrence in float32, the one plain WKV6 of the port
    (the models' ``"reference"`` backend below 128 tokens calls it too).
    r, k, v, w (B, S, H, N); u (H, N) or (B, H, N); state (B, H, N, N).
    Returns (out (B, S, H, N) float32, final state float32)."""
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()[..., None]
    S_ = state.float()
    outs = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        outs.append(torch.einsum("bhn,bhnm->bhm", rf[:, t], S_ + uf * kv))
        S_ = wf[:, t, :, :, None] * S_ + kv
    return torch.stack(outs, dim=1), S_


def wkv6_ref(r, k, v, w, u, s0):
    """The reference's ``wkv6_ref`` layout: r, k, v, w (BH, S, N); u (BH,
    1, N); s0 (BH, N, N), each row one head of :func:`wkv6_scan`.  Returns
    (out in r's dtype, final state float32)."""
    out, s_fin = wkv6_scan(*(a[:, :, None] for a in (r, k, v, w)), u,
                           s0[:, None])
    return out[:, :, 0].to(r.dtype), s_fin[:, 0]


def wkv6_plain(r, k, v, w, u, state):
    """The kernel's plain twin in the models' layout: :func:`wkv6_scan`
    after the reference wrapper's casts of ``w`` and ``u`` to r's dtype."""
    out, s_fin = wkv6_scan(r, k, v, w.to(r.dtype), u.to(r.dtype), state)
    return out.to(r.dtype), s_fin


def _load():
    from repro_torch.kernels import build
    lib = build.load("wkv6")
    if lib.wkv6_chunk_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wkv6_chunk_launch.argtypes = [p] * 6 + [i] * 6 + [p]
        lib.wkv6_chunk_launch.restype = ctypes.c_int
        lib.wkv6_state_launch.argtypes = [p] * 5 + [i] * 6 + [p]
        lib.wkv6_state_launch.restype = ctypes.c_int
    return lib


def _aligned(t):
    """``t`` contiguous at a 16-byte aligned address (the kernel's copies
    move 16 bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@dataclass
class Call:
    """A kernel call's checked and cast inputs, its outputs, the scratch
    its two passes share, and the record of the state pass's blocks."""
    r: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    u: torch.Tensor
    s0: torch.Tensor
    out: torch.Tensor
    s_fin: torch.Tensor
    scratch: torch.Tensor
    block_sms: torch.Tensor
    chunk: int
    head_size: int     # the caller's N; the tensors above may be padded

    def result(self):
        """(out, final state) at the caller's head size."""
        return unpad_heads(self.out, self.s_fin, self.head_size)


def prepare(r, k, v, w, u, state, *, chunk: int = CHUNK) -> Call:
    """Check a call of ``csrc/wkv6.cu``, cast its inputs as the reference
    wrapper does, pad the heads to :func:`kernel_head_size` and allocate
    what its passes write; the kernel runs chunks of ``pick_chunk(S,
    min(chunk, 32))`` tokens.  Raises ``ValueError`` for what the kernel
    does not take."""
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"wkv6_cuda needs CUDA tensors, got {dev}; CPU "
                         f"tensors take the plain twin")
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"wkv6_cuda takes float32 or bfloat16, got "
                         f"{r.dtype}")
    B, S, H, N = r.shape
    for name, t, shape in (("k", k, r.shape), ("v", v, r.shape),
                           ("w", w, r.shape), ("u", u, (H, N)),
                           ("state", state, (B, H, N, N))):
        if tuple(t.shape) != tuple(shape) or t.device != dev:
            raise ValueError(f"{name}: expected {tuple(shape)} on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != r.dtype:
            raise ValueError(f"{name}: expected {r.dtype}, got {t.dtype}")
    n = kernel_head_size(N)
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    C = pick_chunk(S, min(chunk, CHUNK))
    r, k, v, w, u, state = pad_heads(r, k, v, w.to(r.dtype), u.to(r.dtype),
                                     state.float(), n)
    r = _aligned(r)
    s0 = state.contiguous()
    return Call(r, _aligned(k), _aligned(v), _aligned(w), u.contiguous(), s0,
                torch.empty_like(r), torch.empty_like(s0),
                torch.empty(scratch_floats(B, S, H, n, C),
                            dtype=torch.float32, device=dev),
                torch.empty(grid_blocks(B, H, n), dtype=torch.int32,
                            device=dev), C, N)


def chunk_pass(c: Call) -> None:
    """Launch the chunk pass of a prepared call, one block per (batch,
    head, chunk): everything that does not read the state, into the
    scratch.  Counted in ``wkv6_cuda.launches``."""
    from repro_torch.kernels.build import check_launch
    B, S, H, N = c.r.shape
    lib = _load()
    with torch.cuda.device(c.r.device):
        stream = torch.cuda.current_stream(c.r.device).cuda_stream
        err = lib.wkv6_chunk_launch(
            c.r.data_ptr(), c.k.data_ptr(), c.v.data_ptr(), c.w.data_ptr(),
            c.u.data_ptr(), c.scratch.data_ptr(),
            int(c.r.dtype == torch.bfloat16), B, S, H, N, c.chunk, stream)
    check_launch(lib, err, "wkv6 chunk pass")
    wkv6_cuda.launches += 1


def state_pass(c: Call) -> None:
    """Launch the state pass of a prepared call, :func:`grid_blocks`
    blocks, each a group of value columns of one head's state, the chunk
    loop inside: the output and the final state.  Counted in
    ``wkv6_cuda.launches``; records the SM each block ran on
    (``wkv6_cuda.last_block_sms``, int32, -1 where no block ran)."""
    from repro_torch.kernels.build import check_launch
    B, S, H, N = c.r.shape
    lib = _load()
    with torch.cuda.device(c.r.device):
        stream = torch.cuda.current_stream(c.r.device).cuda_stream
        err = lib.wkv6_state_launch(
            c.scratch.data_ptr(), c.s0.data_ptr(), c.out.data_ptr(),
            c.s_fin.data_ptr(), c.block_sms.data_ptr(),
            int(c.r.dtype == torch.bfloat16), B, S, H, N, c.chunk, stream)
    check_launch(lib, err, "wkv6 state pass")
    wkv6_cuda.launches += 1
    wkv6_cuda.last_block_sms = c.block_sms


def wkv6_cuda(r, k, v, w, u, state, *, chunk: int = CHUNK):
    """One call of ``csrc/wkv6.cu``: :func:`chunk_pass`, then
    :func:`state_pass`, two launches on the current stream, each counted
    in ``wkv6_cuda.launches``."""
    c = prepare(r, k, v, w, u, state, chunk=chunk)
    chunk_pass(c)
    state_pass(c)
    return c.result()


wkv6_cuda.launches = 0
wkv6_cuda.last_block_sms = None


def wkv6(r, k, v, w, u, state, *, chunk: int = CHUNK):
    """r, k, v, w (B, S, H, N); u (H, N); state (B, H, N, N) -> (out (B, S,
    H, N) in r's dtype, new state (B, H, N, N) float32): the kernel on CUDA
    tensors, the plain twin on CPU tensors."""
    if r.device.type == "cuda":
        return wkv6_cuda(r, k, v, w, u, state, chunk=chunk)
    return wkv6_plain(r, k, v, w, u, state)
