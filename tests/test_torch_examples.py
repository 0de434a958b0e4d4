"""The port's two examples, run on the CPU at a small size.

``examples/torch_quickstart.py`` and ``examples/torch_sample_sort.py`` run
as scripts with ``--device cpu`` (CUDA is their default), and through
their ``main`` on both transports; the sort's output equals ``np.sort``
of its input at p ∈ {1, 2, 4, 8}, and on the ``ring`` transport it
reaches exactly the collectives its lowering implies: one allgather (the
splitters) and two alltoalls (the buckets and the counts transpose).
"""
import importlib.util
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import transports as tt  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(name):
    path = os.path.join(ROOT, "examples", name)
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("script,args", [
    ("torch_quickstart.py", []),
    ("torch_sample_sort.py", ["--n-per-rank", "512"]),
])
def test_example_scripts_run_on_cpu(script, args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script),
         "--device", "cpu", *args],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "OK" in out.stdout


def test_examples_refuse_without_cuda(monkeypatch):
    from repro_torch.core import KampingError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("torch_quickstart.py", "torch_sample_sort.py"):
        with pytest.raises(KampingError, match="device='cpu'"):
            load(name).main()


@pytest.mark.parametrize("transport", ["native", "ring"])
def test_quickstart_results(transport):
    red, mine, cnt, gathered = load("torch_quickstart.py").main(
        "cpu", transport)
    assert (red == 8).all() and red.shape == (8, 2)
    assert cnt.tolist() == [1, 2, 3, 1, 2, 3, 1, 2]
    assert torch.equal(mine, torch.arange(24.0).reshape(8, 3))
    assert torch.equal(gathered, torch.full((8, 16), 8.0))


@pytest.mark.parametrize("p", (1, 2, 4, 8))
@pytest.mark.parametrize("transport", ["native", "ring"])
def test_sample_sort_equals_np_sort(p, transport):
    data, out = load("torch_sample_sort.py").main(
        "cpu", n_per_rank=1000, p=p, transport=transport, seed=p)
    np.testing.assert_array_equal(out.numpy(),
                                  np.sort(data.numpy().reshape(-1)))


def test_sample_sort_collectives_on_ring(monkeypatch):
    mod = load("torch_sample_sort.py")
    seen = []
    for name in ("all_gather", "all_to_all", "reduce_scatter_sum",
                 "allreduce_sum"):
        orig = getattr(tt.RingTransport, name)

        def wrapped(self, comm, x, *a, _name=name, _orig=orig, **kw):
            seen.append((_name, tuple(torch.as_tensor(x).shape)))
            return _orig(self, comm, x, *a, **kw)

        monkeypatch.setattr(tt.RingTransport, name, wrapped)
    p, n = 8, 1024
    gen = torch.Generator().manual_seed(0)
    data = torch.randint(0, 1 << 30, (p, n), generator=gen,
                         dtype=torch.int32)
    merged, valid = mod.sample_sort(data, gen, transport="ring")
    cap = mod.capacity(n, p)
    assert seen == [("all_gather", (mod.OVERSAMPLE,)),
                    ("all_to_all", (p, cap)),
                    ("all_to_all", (p, 1))]
    assert int(valid.sum()) == p * n
    assert torch.equal(mod.gather_sorted(merged, valid),
                       torch.sort(data.reshape(-1)).values)
