"""Mamba-2's intra-chunk SSD term (``kernels/ssd``) on the CPU, no JAX:
the plain term against the code of ``models/ssm.ssd_chunked`` it was
moved out of, the route (the plain term wherever the kernels do not fit),
the backward kernel's plain twin (``ref.ssd_intra_bwd_ref``) against
autograd, and the kernels' counts and checks. The kernels themselves run
on the card (``tests/test_torch_cuda.py -k ssd``)."""
import pytest
import torch

from repro_torch.kernels import cost
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.kernels.ssd import ssd as ssd_launch
from repro_torch.models import ssm


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the shapes are small, and the suite's parallel
    workers would only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _replaced_intra(CB, cums, dtc, xc):
    """The intra-chunk lines of ``ssd_chunked`` before the term moved to
    ``kernels/ssd/ref.py``, as they were."""
    chunk = cums.shape[2]
    rep = xc.shape[3] // CB.shape[-1]
    xd = xc.dtype
    seg = cums[:, :, :, None, :] - cums[:, :, None, :, :]   # (b,nc,q,q,h)
    qi = torch.arange(chunk, device=xc.device)
    causal = (qi[:, None] >= qi[None, :])[None, None, :, :, None]
    L = torch.exp(torch.where(causal, seg, torch.tensor(
        float("-inf"), dtype=seg.dtype, device=xc.device))) \
        * dtc[:, :, None, :, :]
    CBh = torch.repeat_interleave(CB, rep, dim=-1)    # (b,nc,q,q,h)
    return torch.einsum("bcijh,bcjhp->bcihp", (CBh * L).to(xd), xc)


def _leaves(b=2, nc=3, q=16, h=4, p=8, g=2, dtype=torch.float32, seed=0,
            dt_scale=1.0):
    """(CB, cums, dtc, xc) as ``ssd_chunked`` makes them, each a leaf
    that requires a gradient: C.B of C and B in ``dtype`` (d_state 8),
    dt = softplus(N(-1, 1)), A = -exp(U(0, log 16)), x N(0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    C = (torch.randn((b, nc, q, g, 8), generator=gen) * 0.5).to(dtype)
    B = (torch.randn((b, nc, q, g, 8), generator=gen) * 0.5).to(dtype)
    CB = torch.einsum("bcigm,bcjgm->bcijg", C, B)
    dt = torch.nn.functional.softplus(
        torch.randn((b, nc, q, h), generator=gen) - 1.0) * dt_scale
    A = -torch.exp(torch.rand(h, generator=gen) * torch.log(
        torch.tensor(16.0)))
    cums = torch.cumsum(dt * A, dim=2)
    x = torch.randn((b, nc, q, h, p), generator=gen).to(dtype)
    return [t.detach().requires_grad_() for t in (CB, cums, dt, x)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 2])
def test_ref_term_is_the_code_it_replaces(dtype, g):
    """``ref.ssd_intra_ref`` gives the moved lines' y_intra and every
    input's gradient bit for bit."""
    leaves = _leaves(g=g, h=2 * g, dtype=dtype, seed=g)
    dy = torch.randn(leaves[3].shape, generator=torch.Generator()
                     .manual_seed(7)).to(dtype)
    got = ssd_ref.ssd_intra_ref(*leaves)
    want = _replaced_intra(*leaves)
    assert torch.equal(got, want)
    for a, b in zip(torch.autograd.grad(got, leaves, dy),
                    torch.autograd.grad(want, leaves, dy)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("device,dtype,chunk,head_dim,want", [
    ("cuda", torch.bfloat16, 256, 64, True),      # granite's layer
    ("cuda", torch.bfloat16, 16, 16, True),
    ("cuda", torch.bfloat16, 16, 128, False),     # untested head dims
    ("cuda", torch.bfloat16, 64, 32, True),
    ("cuda", torch.bfloat16, 256, 48, False),
    ("cpu", torch.bfloat16, 256, 64, False),
    ("meta", torch.bfloat16, 256, 64, False),
    ("cuda", torch.float32, 256, 64, False),      # f32 activations
    ("cuda", torch.bfloat16, 1, 64, False),       # a prime prompt's chunk
    ("cuda", torch.bfloat16, 24, 64, False),
    ("cuda", torch.bfloat16, 512, 64, False),
    ("cuda", torch.bfloat16, 256, 8, False),      # the reduced configs'
    ("cuda", torch.bfloat16, 256, 144, False),
])
def test_the_kernels_take_what_they_fit(device, dtype, chunk, head_dim,
                                        want):
    assert ssd_launch.takes(torch.device(device), dtype, chunk,
                            head_dim) is want


@pytest.mark.parametrize("device,dtype,s", [
    ("cpu", torch.bfloat16, 32), ("cpu", torch.float32, 32),
    ("meta", torch.bfloat16, 32), ("cpu", torch.bfloat16, 17),
    ("cpu", torch.bfloat16, 48)])
def test_ssd_chunked_takes_the_plain_term_off_the_card(monkeypatch, device,
                                                       dtype, s):
    """On the CPU and on meta tensors, in f32 and bf16, at chunks of 16, 1
    (17 tokens) and 24 (48 tokens at a configured chunk of 24),
    ``ssd_chunked`` runs the plain term once and never the Function."""
    calls = []

    def counted(*args):
        calls.append(args[3].shape)
        return ssd_ref.ssd_intra_ref(*args)
    monkeypatch.setattr(ssd_ops, "ssd_intra_ref", counted)
    monkeypatch.setattr(ssd_ops._SSDIntra, "apply", lambda *a: pytest.fail(
        "the kernels' Function ran off the card"))
    chunk = {32: 16, 17: 1, 48: 24}[s]
    b, h, p, g, n = 2, 4, 16, 2, 8
    gen = torch.Generator().manual_seed(s)
    x = torch.randn((b, s, h, p), generator=gen).to(dtype)
    dt = torch.rand((b, s, h), generator=gen)
    A = -torch.rand(h, generator=gen) - 0.5
    B = torch.randn((b, s, g, n), generator=gen).to(dtype)
    C = torch.randn((b, s, g, n), generator=gen).to(dtype)
    args = [t.to(device) for t in (x, dt, A, B, C)]
    y, state = ssm.ssd_chunked(*args, chunk)
    assert calls == [(b, s // chunk, chunk, h, p)]
    assert y.shape == (b, s, h, p) and y.device.type == device


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("g,h", [(1, 4), (2, 4), (2, 16)])
def test_function_on_the_cpu_equals_plain_autograd(dtype, tol, g, h):
    """The Function's backward in plain ops on the CPU (its twin
    ``ref.ssd_intra_bwd_ref``, which the kernel is held to on the card):
    every gradient within ``tol`` of its largest value of autograd's
    through the plain term, in the inputs' dtypes. In f32 the two differ
    only in sum order; in bf16 autograd rounds dM to bf16, the twin keeps
    it in f32, as the kernel does."""
    leaves = _leaves(g=g, h=h, dtype=dtype, seed=h + g)
    dy = torch.randn(leaves[3].shape, generator=torch.Generator()
                     .manual_seed(8)).to(dtype)
    got = ssd_ref.ssd_intra_bwd_ref(dy, *[t.detach() for t in leaves])
    want = torch.autograd.grad(ssd_ref.ssd_intra_ref(*leaves), leaves, dy)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        scale = float(w.float().abs().max())
        assert float((a.float() - w.float()).abs().max()) <= tol * scale


def test_the_plain_backward_gives_no_nan_where_segments_overflow():
    """dt large enough that the segments above the diagonal overflow exp:
    the backward twin's gradients stay finite (it never takes their exp
    either)."""
    leaves = [t.detach() for t in _leaves(q=64, dt_scale=50.0, seed=9)]
    cums = leaves[1]
    assert float((cums[:, :, :1] - cums[:, :, -1:]).max()) > 89.0
    y = ssd_ref.ssd_intra_ref(*leaves)
    grads = ssd_ref.ssd_intra_bwd_ref(torch.ones_like(y), *leaves)
    assert torch.isfinite(y).all()
    assert all(bool(torch.isfinite(g_).all()) for g_ in grads)


def test_the_wrappers_refuse_what_the_kernels_do_not_take():
    """The launch wrappers raise on CPU tensors, f32 activations and
    inconsistent shapes; nothing is launched."""
    leaves = [t.detach() for t in _leaves(dtype=torch.bfloat16)]
    with pytest.raises(ValueError, match="take bf16 on CUDA"):
        ssd_launch.ssd_intra_fwd_cuda(*leaves)
    with pytest.raises(ValueError, match="take bf16 on CUDA"):
        ssd_launch.ssd_intra_bwd_cuda(leaves[3], *leaves)
    with pytest.raises(ValueError, match="take bf16 on CUDA"):
        ssd_launch.ssd_intra_fwd_cuda(*leaves[:3], leaves[3].float())
    CB, cums, dtc, xc = leaves
    with pytest.raises(ValueError, match="inconsistent shapes"):
        ssd_launch.dims(CB, cums[:, :, :8], dtc, xc)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        ssd_launch.dims(CB[..., :1].expand(2, 3, 16, 16, 3), cums, dtc, xc)


@pytest.mark.parametrize("rep,want", [(1, 1), (2, 2), (8, 8), (12, 6),
                                      (128, 8), (7, 7), (9, 3)])
def test_heads_per_block_divides_the_group(rep, want):
    assert ssd_launch.heads_per_block(rep) == want


def test_work_counts_at_granites_layer():
    """The kernels' counted work at one granite-4.0-h-small layer (2 x 32
    chunks of 256, 128 heads of 64, one group), by hand: 32,896 pairs a
    chunk and head; x and y (or dy, x and dx) in bf16, four (eight) f32
    bytes a position and head, C.B's lower triangle (and all of dCB)."""
    chunks, q, h, p, g = 64, 256, 128, 64, 1
    pairs = 256 * 257 // 2
    fwd = cost.ssd_intra_fwd(chunks, q, h, p, g)
    bwd = cost.ssd_intra_bwd(chunks, q, h, p, g)
    assert fwd["bf16_flops"] == 2 * 64 * pairs * chunks * h == 34_493_956_096
    assert bwd["bf16_flops"] == 2 * fwd["bf16_flops"]
    assert fwd["bytes"] == chunks * (q * h * (2 * 64 * 2 + 8) + pairs * 2)
    assert bwd["bytes"] == chunks * (q * h * (3 * 64 * 2 + 16)
                                     + (pairs + q * q) * 2)
    assert fwd["flops"] == 4 * pairs * chunks * h
    assert fwd["launches"] == bwd["launches"] == 1


# ---------------------------------------------- the inter-chunk term
def _replaced_inter(cums, dtc, xc, Bc, Cc):
    """The inter-chunk lines of ``ssd_chunked`` before the term moved to
    ``kernels/ssd/ref.py``, as they were."""
    b, nc, _, h, p = xc.shape
    g, n = Bc.shape[3], Bc.shape[4]
    rep = h // g
    xd = xc.dtype
    decay_chunk = torch.exp(cums[:, :, -1]).to(xd)    # (b, nc, h)
    w = (torch.exp(cums[:, :, -1:, :] - cums) * dtc).to(xd)   # (b,nc,q,h)
    Bh = torch.repeat_interleave(Bc, rep, dim=-2).to(xd)      # (b,nc,q,h,n)
    chunk_state = torch.einsum("bcqhn,bcqhp->bchpn", w[..., None] * Bh, xc)
    state = torch.zeros((b, h, p, n), dtype=xd, device=xc.device)
    prev = []
    for c in range(nc):                               # state BEFORE chunk c
        prev.append(state)
        state = state * decay_chunk[:, c, :, None, None] + chunk_state[:, c]
    prev_states = torch.stack(prev, dim=1)            # (b, nc, h, p, n)
    Ch = torch.repeat_interleave(Cc, rep, dim=-2).to(xd)      # (b,nc,q,h,n)
    outw = torch.exp(cums).to(xd)                             # (b,nc,q,h)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", Ch * outw[..., None],
                           prev_states)
    return y_inter, state


def _inter_leaves(b=2, nc=3, q=16, h=4, p=8, g=2, n=8, dtype=torch.float32,
                  seed=0):
    """(cums, dtc, xc, Bc, Cc) as ``ssd_chunked`` makes them, each a leaf
    that requires a gradient: dt = softplus(N(-1, 1)), A = -exp(U(0, log
    16)), x N(0, 1), B and C N(0, 1/4) in ``dtype``."""
    gen = torch.Generator().manual_seed(seed)
    dt = torch.nn.functional.softplus(
        torch.randn((b, nc, q, h), generator=gen) - 1.0)
    A = -torch.exp(torch.rand(h, generator=gen) * torch.log(
        torch.tensor(16.0)))
    cums = torch.cumsum(dt * A, dim=2)
    x = torch.randn((b, nc, q, h, p), generator=gen).to(dtype)
    B = (torch.randn((b, nc, q, g, n), generator=gen) * 0.5).to(dtype)
    C = (torch.randn((b, nc, q, g, n), generator=gen) * 0.5).to(dtype)
    return [t.detach().requires_grad_() for t in (cums, dt, x, B, C)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,h", [(1, 4), (2, 4)])
def test_inter_ref_term_is_the_code_it_replaces(dtype, g, h):
    """``ref.ssd_inter_ref`` gives the moved lines' y_inter, final state and
    every input's gradient bit for bit."""
    leaves = _inter_leaves(g=g, h=h, dtype=dtype, seed=g + h)
    gen = torch.Generator().manual_seed(3)
    dy = torch.randn(leaves[2].shape, generator=gen).to(dtype)
    ds = torch.randn((2, h, 8, 8), generator=gen).to(dtype)
    got = ssd_ref.ssd_inter_ref(*leaves)
    want = _replaced_inter(*leaves)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(torch.autograd.grad(got, leaves, (dy, ds)),
                    torch.autograd.grad(want, leaves, (dy, ds))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("device,dtype,chunk,head_dim,d_state,want", [
    ("cuda", torch.bfloat16, 256, 64, 128, True),     # granite's layer
    ("cuda", torch.bfloat16, 128, 64, 128, True),     # mamba2-2.7b's
    ("cuda", torch.bfloat16, 64, 64, 16, True),       # jamba's
    ("cuda", torch.bfloat16, 16, 16, 16, True),       # reduced granite's
    ("cuda", torch.bfloat16, 256, 64, 64, False),     # unheld d_states
    ("cuda", torch.bfloat16, 256, 64, 8, False),
    ("cuda", torch.bfloat16, 256, 128, 128, False),   # unheld head dims
    ("cpu", torch.bfloat16, 256, 64, 128, False),
    ("meta", torch.bfloat16, 256, 64, 128, False),
    ("cuda", torch.float32, 256, 64, 128, False),     # f32 activations
    ("cuda", torch.bfloat16, 1, 64, 128, False),      # a prime prompt's
    ("cuda", torch.bfloat16, 24, 64, 128, False),
])
def test_the_inter_kernels_take_what_they_fit(device, dtype, chunk,
                                              head_dim, d_state, want):
    assert ssd_launch.inter_takes(torch.device(device), dtype, chunk,
                                  head_dim, d_state) is want


@pytest.mark.parametrize("device,dtype,s,n", [
    ("cpu", torch.bfloat16, 32, 16), ("cpu", torch.float32, 32, 128),
    ("meta", torch.bfloat16, 32, 16), ("cpu", torch.bfloat16, 17, 16),
    ("cpu", torch.bfloat16, 32, 32)])
def test_ssd_chunked_takes_the_plain_inter_term_off_the_card(
        monkeypatch, device, dtype, s, n):
    """On the CPU and on meta tensors, in f32 and bf16, at chunks of 16 and
    1 (17 tokens), at held and unheld d_states, ``ssd_chunked`` runs the
    plain inter-chunk term once and never the Function, and returns its
    final state."""
    calls = []

    def counted(*args):
        calls.append(args[2].shape)
        return ssd_ref.ssd_inter_ref(*args)
    monkeypatch.setattr(ssd_ops, "ssd_inter_ref", counted)
    monkeypatch.setattr(ssd_ops._SSDInter, "apply", lambda *a: pytest.fail(
        "the inter kernels' Function ran off the card"))
    chunk = 1 if s == 17 else 16
    b, h, p, g = 2, 4, 16, 2
    gen = torch.Generator().manual_seed(s + n)
    x = torch.randn((b, s, h, p), generator=gen).to(dtype)
    dt = torch.rand((b, s, h), generator=gen)
    A = -torch.rand(h, generator=gen) - 0.5
    B = torch.randn((b, s, g, n), generator=gen).to(dtype)
    C = torch.randn((b, s, g, n), generator=gen).to(dtype)
    args = [t.to(device) for t in (x, dt, A, B, C)]
    y, state = ssm.ssd_chunked(*args, chunk)
    assert calls == [(b, s // chunk, chunk, h, p)]
    assert state.shape == (b, h, p, n) and state.device.type == device
    if device == "cpu":
        xc = args[0].reshape(b, s // chunk, chunk, h, p)
        cums = torch.cumsum(args[1].reshape(b, s // chunk, chunk, h)
                            * args[2], dim=2)
        want = ssd_ref.ssd_inter_ref(
            cums, args[1].reshape(b, s // chunk, chunk, h), xc,
            args[3].reshape(b, s // chunk, chunk, g, n),
            args[4].reshape(b, s // chunk, chunk, g, n))[1]
        assert torch.equal(state, want)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2.0 ** -8)])
@pytest.mark.parametrize("g,h,final", [(1, 4, True), (2, 4, False),
                                       (2, 8, True)])
def test_inter_function_on_the_cpu_equals_plain_autograd(dtype, tol, g, h,
                                                         final):
    """The inter kernels' backward in plain ops on the CPU (their twin
    ``ref.ssd_inter_bwd_ref``, which the kernels are held to on the card):
    every gradient within ``tol`` of its largest value of autograd's
    through the plain term, in the inputs' dtypes, with and without a
    gradient of the final state. The twin rounds where autograd's bf16
    tensors round, so the two differ only in the f32 sums' order."""
    leaves = _inter_leaves(g=g, h=h, dtype=dtype, seed=h + g)
    gen = torch.Generator().manual_seed(8)
    dy = torch.randn(leaves[2].shape, generator=gen).to(dtype)
    ds = torch.randn((2, h, 8, 8), generator=gen).to(dtype) if final \
        else None
    y, state = ssd_ref.ssd_inter_ref(*leaves)
    want = torch.autograd.grad((y, state) if final else y, leaves,
                               (dy, ds) if final else dy)
    got = ssd_ref.ssd_inter_bwd_ref(dy, ds, *[t.detach() for t in leaves])
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        scale = float(w.float().abs().max())
        assert float((a.float() - w.float()).abs().max()) <= tol * scale


def test_the_inter_wrappers_refuse_what_the_kernels_do_not_take():
    """The inter launch wrappers raise on CPU tensors, f32 activations, an
    unheld d_state and inconsistent shapes; nothing is launched."""
    leaves = [t.detach() for t in _inter_leaves(dtype=torch.bfloat16)]
    cums, dtc, xc, Bc, Cc = leaves
    with pytest.raises(ValueError, match="take bf16 on CUDA"):
        ssd_launch.ssd_inter_fwd_cuda(*leaves)
    with pytest.raises(ValueError, match="take bf16 on CUDA"):
        ssd_launch.ssd_inter_bwd_cuda(xc, None, *leaves,
                                      torch.zeros((2, 3, 4, 8, 8)))
    with pytest.raises(ValueError, match="take bf16 on CUDA"):
        ssd_launch.ssd_inter_fwd_cuda(cums, dtc, xc.float(), Bc, Cc)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        ssd_launch.inter_dims(cums[:, :, :8], dtc, xc, Bc, Cc)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        ssd_launch.inter_dims(cums, dtc, xc, Bc, Cc[..., :4])
    with pytest.raises(ValueError, match="inconsistent shapes"):
        ssd_launch.inter_dims(cums, dtc, xc, Bc[:, :, :, :1].expand(
            2, 3, 16, 3, 8), Cc[:, :, :, :1].expand(2, 3, 16, 3, 8))


def test_rows_reads_the_in_projection_split_in_place():
    """x, B and C as ``ssm_inner`` splits them from the conv's output (b,
    s, di + 2 g n) reach the kernels as views with the conv's row stride;
    a view whose positions are not one stride apart is copied."""
    b, s, h, p, g, n, q = 2, 64, 4, 16, 1, 16, 16
    conv = torch.zeros((b, s, h * p + 2 * g * n), dtype=torch.bfloat16)
    xin, B, _ = torch.split(conv, [h * p, g * n, g * n], dim=-1)
    for t, k, w in ((xin, h, p), (B, g, n)):
        view = t.reshape(b, s, k, w).reshape(b, s // q, q, k, w)
        got, ld = ssd_launch.rows(view)
        assert got.data_ptr() == view.data_ptr() and ld == conv.shape[-1]
    odd = torch.zeros((b, s, 2, h, p), dtype=torch.bfloat16)[:, :, 0]
    got, ld = ssd_launch.rows(odd.reshape(b, s // q, q, h, p)[:, ::2])
    assert got.is_contiguous() and ld == h * p


def test_inter_work_counts_at_granites_layer():
    """The inter kernels' counted work at one granite-4.0-h-small layer (2
    rows of 32 chunks of 256, 128 heads of 64, d_state 128, one group), by
    hand: 2 q p n products a chunk and head for each of the forward's two
    and the backward's four; each state tensor (134 MB) moved 4 and 6
    times."""
    b, nc, q, h, p, g, n = 2, 32, 256, 128, 64, 1, 128
    fwd = cost.ssd_inter_fwd(b, nc, q, h, p, g, n)
    bwd = cost.ssd_inter_bwd(b, nc, q, h, p, g, n)
    st = b * nc * h * p * n * 2
    assert st == 134_217_728
    assert fwd["bf16_flops"] == 4 * q * p * n * b * nc * h == 68_719_476_736
    assert bwd["bf16_flops"] == 2 * fwd["bf16_flops"]
    rows = b * nc * q
    assert fwd["bytes"] == (rows * (2 * h * p * 2 + 2 * h * 4 + 2 * n * 2)
                            + 4 * st + b * h * p * n * 2)
    assert bwd["bytes"] == (rows * (3 * h * p * 2 + 8 * h * 4 + 4 * n * 2)
                            + 6 * st + b * h * p * n * 2)
    assert fwd["launches"] == bwd["launches"] == 1
