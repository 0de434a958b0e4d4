"""The kernel wrappers and autograd (ROADMAP C8, A2).

The CUDA kernels have no backward yet, so on the CUDA route each wrapper
refuses, under grad mode, an input that requires grad (the card tests in
``tests/test_torch_card.py`` hold the three wrappers to it).  Here, on the
CPU: the refusal's rule itself, and the plain route of each wrapper,
which stays differentiable.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import KampingError  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.guard import refuse_grad  # noqa: E402
from repro_torch.kernels.rg_lru import ops as lru_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402


def _flash(g):
    q = torch.randn(1, 8, 2, 64, generator=g, requires_grad=True)
    kv = torch.randn(1, 8, 1, 64, generator=g)
    return q, lambda: flash_ops.flash_attention(q, kv, kv)


def _ssd(g):
    x = torch.randn(1, 16, 2, 8, generator=g, requires_grad=True)
    a = torch.rand(1, 16, 2, generator=g).clamp(0.3, 0.99)
    Bm = torch.randn(1, 16, 1, 8, generator=g)
    return x, lambda: ssd_ops.ssd_scan(x, a, Bm, Bm, chunk=8)


def _lru(g):
    a = torch.rand(1, 16, 4, generator=g)
    b = torch.randn(1, 16, 4, generator=g, requires_grad=True)
    return b, lambda: lru_ops.lru_scan(a, b)


@pytest.mark.parametrize("make", [_flash, _ssd, _lru],
                         ids=["flash_attention", "ssd_scan", "lru_scan"])
def test_plain_route_stays_differentiable(make):
    leaf, call = make(torch.Generator().manual_seed(0))
    out = call()
    assert out.grad_fn is not None
    out.sum().backward()
    assert leaf.grad is not None and bool(torch.isfinite(leaf.grad).all())


@pytest.mark.parametrize("requires_grad, grad_mode, raises", [
    (True, True, True),
    (True, False, False),
    (False, True, False),
])
def test_refuse_grad_rule(requires_grad, grad_mode, raises):
    ts = (torch.zeros(2), torch.zeros(2, requires_grad=requires_grad))
    with torch.set_grad_enabled(grad_mode):
        if raises:
            with pytest.raises(KampingError, match="ROADMAP A2"):
                refuse_grad("kernel", *ts)
        else:
            refuse_grad("kernel", *ts)
