"""The port's public constructors run on the card unless the caller asks for
the CPU: no public function or method of ``mcpx_torch`` defaults a
``device`` parameter to the CPU (an AST walk of the package), and each of
the five tensor constructors (``init_params``, ``init_kv_cache``,
``params_from_numpy``, ``load_npz``, ``init_paged_kv``), called with no
device on a box without a card, raises ``EngineError`` naming
``device='cpu'``; called with ``device="cpu"`` it gives CPU tensors equal to
the reference package's where the reference has the function (the
checkpoint's tree for ``params_from_numpy`` and ``load_npz``, shapes and
zeros for the two caches; ``init_params``'s draws differ by design, so its
shapes and types)."""

import ast
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from mcpx.engine.kv_cache import init_paged_kv as jinit_paged_kv
from mcpx.models.gemma import model as jm
from mcpx.models.gemma.config import GemmaConfig as JConfig
from mcpx.models.train import load_npz as jload_npz
from mcpx_torch.core.errors import EngineError
from mcpx_torch.engine.kv_cache import init_paged_kv
from mcpx_torch.models.gemma import model as tm
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.gemma.params import load_npz, params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "mcpx", "models", "checkpoints", "planner_test_bpe.npz")
JCFG = JConfig(vocab_size=384, d_model=64, n_layers=3, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96)
TCFG = GemmaConfig(**dataclasses.asdict(JCFG))


def _cpu_default(node: ast.expr) -> bool:
    """A default that names the CPU: ``"cpu"`` (any case, with an index or
    not) or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.lower().split(":")[0] == "cpu"
    if isinstance(node, ast.Call) and ast.unparse(node.func) in ("torch.device", "device"):
        return bool(node.args) and _cpu_default(node.args[0])
    return False


def _public_defs(tree: ast.Module):
    """Module-level functions and methods of module-level classes whose
    names do not start with one underscore (dunders count as public)."""
    def public(name: str) -> bool:
        return not name.startswith("_") or (name.startswith("__") and name.endswith("__"))

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and public(node.name):
            yield node.name, node
        elif isinstance(node, ast.ClassDef) and public(node.name):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) and public(item.name):
                    yield f"{node.name}.{item.name}", item


def _cpu_device_params(tree: ast.Module) -> tuple[list, int]:
    """(public functions with a parameter that defaults to the CPU, as
    ``name(param)``; the count of public ``device`` parameters seen): a
    ``device`` parameter defaulting to a CPU string or device, or any
    parameter defaulting to ``torch.device("cpu")``."""
    flagged, seen = [], 0
    for name, fn in _public_defs(tree):
        a = fn.args
        pos = a.posonlyargs + a.args
        pairs = list(zip(pos[len(pos) - len(a.defaults):], a.defaults))
        pairs += [(k, v) for k, v in zip(a.kwonlyargs, a.kw_defaults) if v is not None]
        for arg, default in pairs:
            seen += arg.arg == "device"
            if (arg.arg == "device" or isinstance(default, ast.Call)) and _cpu_default(default):
                flagged.append(f"{name}({arg.arg})")
    return flagged, seen


def test_no_public_function_defaults_device_to_the_cpu():
    offenders, seen = [], 0
    for d, _, files in os.walk(os.path.join(ROOT, "mcpx_torch")):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            with open(path) as fh:
                flagged, n = _cpu_device_params(ast.parse(fh.read(), path))
            seen += n
            offenders += [f"{os.path.relpath(path, ROOT)}: {x}" for x in flagged]
    assert seen >= 10, "the walk found too few device parameters: it reads nothing"
    assert offenders == []


def test_the_walk_flags_a_cpu_default():
    src = (
        "def a(x, device='cpu'): pass\n"
        "def b(*, device=torch.device('cpu')): pass\n"
        "def c(device=None, fmt='cpu'): pass\n"
        "class C:\n    def m(self, device='cuda'): pass\n    def n(self, dev=torch.device('CPU:0')): pass\n"
        "def _private(device='cpu'): pass\n"
    )
    assert _cpu_device_params(ast.parse(src)) == (["a(device)", "b(device)", "C.n(dev)"], 4)


def _call(name: str, **kw):
    """One constructor at the small config; ``kw`` is its device argument."""
    if name == "init_params":
        return tm.init_params(TCFG, torch.Generator().manual_seed(0), **kw)
    if name == "init_kv_cache":
        return tm.init_kv_cache(TCFG, 2, 8, **kw)
    if name == "params_from_numpy":
        with np.load(CKPT) as z:
            return params_from_numpy({k: z[k] for k in z.files}, **kw)
    if name == "load_npz":
        return load_npz(CKPT, **kw)
    return init_paged_kv(TCFG, 5, 4, **kw)


def _reference(name: str):
    if name == "init_params":
        return jax.eval_shape(lambda: jm.init_params(JCFG, jax.random.PRNGKey(0)))
    if name == "init_kv_cache":
        return jm.init_kv_cache(JCFG, 2, 8)
    if name in ("params_from_numpy", "load_npz"):
        return jload_npz(CKPT)
    return jinit_paged_kv(JCFG, 5, 4)


def _leaves(tree) -> dict:
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[f"{prefix}{k}"] = v

    walk(tree, "")
    return out


CONSTRUCTORS = ["init_params", "init_kv_cache", "params_from_numpy", "load_npz", "init_paged_kv"]


@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_constructor_without_a_device_raises_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(EngineError, match="device='cpu'"):
        _call(name)


@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_constructor_on_the_cpu_matches_the_reference(name):
    got, ref = _leaves(_call(name, device="cpu")), _leaves(_reference(name))
    assert set(got) == set(ref)
    for key, t in got.items():
        r = ref[key]
        assert t.device.type == "cpu", key
        assert tuple(t.shape) == tuple(r.shape), key
        assert str(t.dtype).removeprefix("torch.") == str(r.dtype), key
        if name == "init_params":
            if key.endswith("norm"):
                assert not t.any(), key
            continue
        want = np.asarray(r)
        if want.dtype.name == "bfloat16":
            assert torch.equal(t.view(torch.int16), torch.from_numpy(want.view(np.int16).copy())), key
        else:
            np.testing.assert_array_equal(t.numpy(), want, err_msg=key)


def test_init_params_refuses_a_generator_on_another_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(EngineError, match="generator is on cpu.*go to cuda"):
        tm.init_params(TCFG, torch.Generator().manual_seed(0), device="cuda")
