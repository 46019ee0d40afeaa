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
