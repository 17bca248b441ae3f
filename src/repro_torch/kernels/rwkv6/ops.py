"""Chunked WKV6 recurrence (RWKV-6 linear attention).

Port of ``repro.kernels.rwkv6`` (``kernel.wkv6_bhsn`` and the ``ops.wkv6``
wrapper).  :func:`wkv6` takes the models' layout, ``r, k, v, w (B, S, H,
N)``, ``u (H, N)``, ``state (B, H, N, N)``, and casts ``w`` and ``u`` to
``r``'s dtype as the reference wrapper does (in bfloat16 and float16 that
rounds the decay, each its own way).  On CUDA tensors it is the
hand-written kernel ``csrc/wkv6.cu`` for float32, bfloat16 or float16
inputs, two launches (:func:`chunk_pass`, :func:`state_pass`; past a head of
1024 a third, :func:`add_pass`); on CPU tensors the plain twin
:func:`wkv6_plain`, the sequential :func:`wkv6_scan` (the reference's
``ref.wkv6_ref``).  The output has ``r``'s dtype, the final state is
float32.

The kernel is built for head sizes that are multiples of 16 and chunks of
at most 32 tokens: up to 192 each pass runs a block per problem, past 192
a cluster of ``ceil(N / 64)`` blocks, each holding 64 channels (the chunk
pass) or 64 rows of the state (the state pass), whose parts are added in
rank order; past 1024 (more than the card's 16-block cluster) the blocks
of a problem are split over ``ceil(N / 1024)`` clusters
(:func:`head_split`), each of which writes its part of the output, and
:func:`add_pass` adds the parts in cluster order.  The wrapper serves
every head size by zero padding (:func:`pad_heads`; to a multiple of 16 up
to 256, of 64 above) and any ``chunk`` by running the largest chunk of at
most 32 that divides S (the chunk is a tiling of the same recurrence).  A
call whose scratch, parts and padded copies the card cannot hold raises
with the byte count and launches nothing (``kernels.allocating``).

The kernel is forward only: :func:`wkv6` and :func:`wkv6_cuda` raise when
grad mode is on and an input requires grad (``kernels.refuse_grad``), on
CUDA and CPU tensors alike.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import allocating, counted, refuse_grad

CHUNK = 32
# csrc/wkv6.cu: the largest head of the one-block passes (WKV6_HEAD_SIZES:
# the multiples of 16 whose state-pass block fits shared memory), the
# channels or state rows of a block of the cluster passes beyond it
# (kClusterRows), the blocks of the card's largest cluster (kMaxCluster),
# and the value columns of the state a block owns
ONE_BLOCK_MAX = 192
CLUSTER_ROWS = 64
MAX_CLUSTER = 16
COLUMNS_PER_BLOCK = 16
# the kernel's dtype codes (wkv6_chunk_launch and the others)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the head sizes the wrapper runs on one block or one cluster a problem:
# multiples of 16 up to 256, of 64 above, up to 1024 (clusters of up to 16
# blocks, the card's largest); past 1024 every multiple of 64, on several
HEAD_SIZES = tuple(range(16, 257, 16)) + tuple(range(320, 1025, 64))


def kernel_head_size(N: int) -> int:
    """The head size the kernel runs a head of ``N`` at: the smallest of
    :data:`HEAD_SIZES` that holds it, past 1024 the next multiple of 64."""
    for n in HEAD_SIZES:
        if n >= N:
            return n
    return -(-N // 64) * 64


def head_split(n: int):
    """(clusters, blocks of a cluster) of one problem at a kernel head of
    ``n``: (1, 1) up to :data:`ONE_BLOCK_MAX`; past it the head's
    ``ceil(n / 64)`` row blocks over ``ceil(blocks / 16)`` clusters of as
    many blocks each, at most 16 (the last rows zero)."""
    if n <= ONE_BLOCK_MAX:
        return 1, 1
    blocks = -(-n // CLUSTER_ROWS)
    nc = -(-blocks // MAX_CLUSTER)
    return nc, -(-blocks // nc)


def cluster_blocks(n: int) -> int:
    """Blocks of a cluster for a kernel head of ``n``: 1 up to
    :data:`ONE_BLOCK_MAX` (one block per problem), ``ceil(n / 64)`` up to
    1024, past it the split of :func:`head_split`."""
    return head_split(n)[1]


def launches_per_call(N: int) -> int:
    """Kernel launches of one call at a head of ``N``: the chunk and state
    passes, and past 1024 the add of the clusters' parts."""
    return 2 + (head_split(kernel_head_size(N))[0] > 1)


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
    state padded to :func:`kernel_head_size`), times the blocks of a
    problem's clusters (:func:`head_split`: the state's rows split over
    them).  (Its chunk pass runs as many blocks per (batch, head,
    chunk).)"""
    n = kernel_head_size(N)
    nc, g = head_split(n)
    return B * H * (n // COLUMNS_PER_BLOCK) * nc * g


def scratch_floats(B: int, S: int, H: int, N: int, C: int) -> int:
    """float32 scratch the chunk pass hands the state pass, per (batch,
    head, chunk), for a kernel head of ``N``: r~ (``CHUNK`` rows of N + 4),
    the chunk's own output y (``CHUNK`` x N), its state increment k~^T v
    (N x N) and its decay.  Past :data:`ONE_BLOCK_MAX` the rows are padded
    to the problem's NC x G x 64 (:func:`head_split`): r~ in NC G blocks
    of ``CHUNK`` rows of 68, each cluster's part of y, k~^T v and the decay
    on NC G x 64 rows."""
    nc, g = head_split(N)
    if N <= ONE_BLOCK_MAX:
        per_chunk = CHUNK * (N + 4) + (CHUNK + N) * N + N
    else:
        rows = nc * g * CLUSTER_ROWS
        per_chunk = (nc * g * CHUNK * (CLUSTER_ROWS + 4)
                     + (nc * CHUNK + rows) * N + rows)
    return per_chunk * B * H * (S // C)


def parts_floats(B: int, S: int, H: int, N: int) -> int:
    """float32 parts of the output the state pass writes past a head of
    1024, one per cluster of a problem (0 up to 1024: it writes the output
    itself), for a kernel head of ``N``."""
    nc = head_split(N)[0]
    return 0 if nc == 1 else nc * B * S * H * N


def flops_by_unit(B: int, S: int, H: int, N: int, C: int):
    """(products, elementwise): float32 operations of the chunked algebra
    per call.  Per chunk and head the products r~S (2CN^2), the strictly
    lower r~k~^T and its product with v (2 x C(C-1)N) and k~^T v (2CN^2);
    the state update (2N^2) and ~11 elementwise operations per (token,
    channel)."""
    chunks = B * H * (S // C)
    return (chunks * (4 * C * N * N + 2 * C * (C - 1) * N),
            chunks * (11 * C * N + 2 * N * N))


def work(B: int, S: int, H: int, N: int, C: int, itemsize: int):
    """(flops, bytes) of one call at the caller's head size ``N`` and
    chunks of ``C``: both of :func:`flops_by_unit`'s counts; r, k, v, w
    (cast to r's dtype by the wrapper) read and the output written in
    ``itemsize`` bytes, u, the float32 state read and written."""
    products, elementwise = flops_by_unit(B, S, H, N, C)
    return (products + elementwise,
            itemsize * (5 * B * S * H * N + H * N) + 4 * 2 * B * H * N * N)


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
        lib.wkv6_state_launch.argtypes = [p] * 6 + [i] * 6 + [p]
        lib.wkv6_state_launch.restype = ctypes.c_int
        lib.wkv6_add_launch.argtypes = [p, p, ctypes.c_longlong, i, i, p]
        lib.wkv6_add_launch.restype = ctypes.c_int
    return lib


def _aligned(t):
    """``t`` contiguous at a 16-byte aligned address (the kernel's copies
    move 16 bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@dataclass
class Call:
    """A kernel call's checked and cast inputs, its outputs, the scratch
    its two passes share, past a head of 1024 the clusters' parts of the
    output (else None), and the record of the state pass's blocks."""
    r: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    u: torch.Tensor
    s0: torch.Tensor
    out: torch.Tensor
    s_fin: torch.Tensor
    scratch: torch.Tensor
    parts: Optional[torch.Tensor]
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
    refuse_grad("wkv6_cuda", r, k, v, w, u, state)
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"wkv6_cuda needs CUDA tensors, got {dev}; CPU "
                         f"tensors take the plain twin")
    if r.dtype not in DTYPE_CODES:
        raise ValueError(f"wkv6_cuda takes float32, bfloat16 or float16, "
                         f"got {r.dtype}")
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
    with allocating("wkv6_cuda", call_bytes(B, S, H, N, C,
                                              r.element_size()), dev):
        r, k, v, w, u, state = pad_heads(r, k, v, w.to(r.dtype),
                                         u.to(r.dtype), state.float(), n)
        r = _aligned(r)
        s0 = state.contiguous()
        n_parts = parts_floats(B, S, H, n)
        return Call(r, _aligned(k), _aligned(v), _aligned(w), u.contiguous(),
                    s0, torch.empty_like(r), torch.empty_like(s0),
                    torch.empty(scratch_floats(B, S, H, n, C),
                                dtype=torch.float32, device=dev),
                    torch.empty(n_parts, dtype=torch.float32, device=dev)
                    if n_parts else None,
                    torch.empty(grid_blocks(B, H, n), dtype=torch.int32,
                                device=dev), C, N)


def call_bytes(B: int, S: int, H: int, N: int, C: int, itemsize: int) -> int:
    """Device bytes a call allocates at a head of ``N`` and chunks of ``C``:
    the scratch, the clusters' parts, the output and final state, the
    block record and, where N is padded, the padded inputs and state."""
    n = kernel_head_size(N)
    floats = (scratch_floats(B, S, H, n, C) + parts_floats(B, S, H, n)
              + B * H * n * n + grid_blocks(B, H, n))
    padded = (5 * B * S * H * n + H * n) * itemsize + 4 * B * H * n * n
    return 4 * floats + itemsize * B * S * H * n + (padded if n != N else 0)


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
            c.u.data_ptr(), c.scratch.data_ptr(), DTYPE_CODES[c.r.dtype], B,
            S, H, N, c.chunk, stream)
    check_launch(lib, err, "wkv6 chunk pass")
    _count(c)


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
            0 if c.parts is None else c.parts.data_ptr(),
            c.s_fin.data_ptr(), c.block_sms.data_ptr(),
            DTYPE_CODES[c.r.dtype], B, S, H, N, c.chunk, stream)
    check_launch(lib, err, "wkv6 state pass")
    _count(c)
    wkv6_cuda.last_block_sms = c.block_sms


def add_pass(c: Call) -> None:
    """Past a head of 1024: launch the add of the clusters' float32 parts
    of the output, in cluster order, rounded to the output's dtype (one
    thread an element).  Counted in ``wkv6_cuda.launches``."""
    from repro_torch.kernels.build import check_launch
    lib = _load()
    with torch.cuda.device(c.r.device):
        stream = torch.cuda.current_stream(c.r.device).cuda_stream
        err = lib.wkv6_add_launch(
            c.parts.data_ptr(), c.out.data_ptr(), c.out.numel(),
            head_split(c.r.shape[-1])[0], DTYPE_CODES[c.r.dtype], stream)
    check_launch(lib, err, "wkv6 add of the clusters' parts")
    _count(c)


def _count(c: Call) -> None:
    """Count one launch in ``wkv6_cuda.launches``, in its tally by dtype,
    and past a head of 1024 in ``wkv6_cuda.multi_cluster_launches``."""
    wkv6_cuda.launches += 1
    wkv6_cuda.launches_by_dtype[str(c.r.dtype).split(".")[-1]] += 1
    wkv6_cuda.multi_cluster_launches += c.parts is not None


def wkv6_cuda(r, k, v, w, u, state, *, chunk: int = CHUNK):
    """One call of ``csrc/wkv6.cu``: :func:`chunk_pass`, then
    :func:`state_pass` (past a head of 1024 then :func:`add_pass`),
    launches on the current stream, each counted in
    ``wkv6_cuda.launches``."""
    c = prepare(r, k, v, w, u, state, chunk=chunk)
    chunk_pass(c)
    state_pass(c)
    if c.parts is not None:
        add_pass(c)
    return c.result()


wkv6_cuda.launches = 0
wkv6_cuda.launches_by_dtype = {"float32": 0, "bfloat16": 0, "float16": 0}
wkv6_cuda.multi_cluster_launches = 0
wkv6_cuda.last_block_sms = None


def wkv6(r, k, v, w, u, state, *, chunk: int = CHUNK):
    """r, k, v, w (B, S, H, N); u (H, N); state (B, H, N, N) -> (out (B, S,
    H, N) in r's dtype, new state (B, H, N, N) float32): the kernel on CUDA
    tensors, the plain twin on CPU tensors; either refuses a gradient.
    Under a cost counter one call of ``wkv6`` with :func:`work` at the
    kernel's chunk and the launches the card makes for it."""
    B, S, H, N = r.shape
    with counted("wkv6", lambda: work(
            B, S, H, N, pick_chunk(S, min(chunk, CHUNK)), r.element_size()),
            launches_per_call(N)):
        if r.device.type == "cuda":
            return wkv6_cuda(r, k, v, w, u, state, chunk=chunk)
        refuse_grad("wkv6", r, k, v, w, u, state)
        return wkv6_plain(r, k, v, w, u, state)
