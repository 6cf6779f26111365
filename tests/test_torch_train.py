"""The port's trainer (``mcpx_torch.models.train``) against the reference's
(``mcpx/models/train.py``, optax's AdamW), on the CPU at the test preset:
from one init (the reference's ``init_params(PRNGKey(0))`` carried across)
the two train on the same rows to the same losses and weights; optax's
schedule, clip and decay mask step for step; the cache-free training
forward against ``prefill``; the reference's own loss-drop test; and
``.npz`` checkpoints that each package reads from the other bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mcpx.models.bpe import BPETokenizer as JTokenizer
from mcpx.models.corpus import CorpusConfig as JCorpusConfig
from mcpx.models.corpus import build_corpus_sync as jbuild
from mcpx.models.gemma.config import GemmaConfig as JGemmaConfig
from mcpx.models.gemma.model import init_params as jinit
from mcpx.models.train import TrainConfig as JTrainConfig
from mcpx.models.train import load_npz as jload_npz
from mcpx.models.train import save_npz as jsave_npz
from mcpx.models.train import train as jtrain
from mcpx_torch.core.errors import EngineError
from mcpx_torch.models.bpe import BPETokenizer
from mcpx_torch.models.corpus import CorpusConfig, build_corpus_sync
from mcpx_torch.models.gemma import model as tm
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.gemma.params import load_or_init, params_from_numpy
from mcpx_torch.models.train import (
    TrainConfig, _clip_by_global_norm, flatten_params, load_npz, lr_schedule, save_npz, train, unflatten_params,
)

from test_torch_model import CKPT

V = 3072  # the BPE vocab's padded size


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Small CPU forwards run faster on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpora():
    return (build_corpus_sync(BPETokenizer(), CorpusConfig(n_examples=96, registry_size=120, seed=3), device="cpu"),
            jbuild(JTokenizer(), JCorpusConfig(n_examples=96, registry_size=120, seed=3)))


@pytest.fixture(scope="module")
def shared_init():
    """The reference's random init in float32, as numpy."""
    cfg = dataclasses.replace(JGemmaConfig.named("test", vocab_size=V), dtype="float32")
    return jax.tree.map(np.asarray, jinit(cfg, jax.random.PRNGKey(0)))


def _np(tree) -> dict:
    return {k: np.asarray(v.float().numpy() if isinstance(v, torch.Tensor) else v, np.float32)
            for k, v in flatten_params(tree).items()}


def test_twelve_steps_match_the_reference_from_one_init(corpora, shared_init):
    """12 steps at batch 8, warmup 3: every step's loss within 1e-5
    relative, the weights within 1e-4, the eval token accuracy equal."""
    port_corpus, ref_corpus = corpora
    tcfg = dict(steps=12, batch_size=8, warmup_steps=3, log_every=1)
    jparams, jreport = jtrain(JGemmaConfig.named("test", vocab_size=V), ref_corpus, JTrainConfig(**tcfg),
                              init=jax.tree.map(jnp.asarray, shared_init))
    params, report = train(GemmaConfig.named("test", vocab_size=V), port_corpus, TrainConfig(**tcfg),
                           device="cpu", init=params_from_numpy(shared_init, device="cpu"))
    assert set(report) == set(jreport)
    assert [s for s, _ in report["loss_log"]] == [s for s, _ in jreport["loss_log"]] == list(range(12))
    for (_, a), (_, b) in zip(report["loss_log"], jreport["loss_log"]):
        assert abs(a - b) <= 1e-5 * abs(b), (report["loss_log"], jreport["loss_log"])
    assert report["first_loss"] == pytest.approx(jreport["first_loss"], rel=1e-5)
    assert report["final_loss"] == pytest.approx(jreport["final_loss"], rel=1e-5)
    assert report["eval_token_accuracy"] == jreport["eval_token_accuracy"]
    got, want = _np(params), _np(jax.tree.map(np.asarray, jparams))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    assert all(t.dtype == torch.float32 and not t.requires_grad for t in flatten_params(params).values())


def test_first_update_has_lr_zero_and_leaves_the_weights(corpora, shared_init):
    """optax evaluates the schedule before the update count moves: the first
    update has lr 0, so one step returns the init bit for bit, on both."""
    port_corpus, ref_corpus = corpora
    tcfg = dict(steps=1, batch_size=8, warmup_steps=3, log_every=1)
    params, _ = train(GemmaConfig.named("test", vocab_size=V), port_corpus, TrainConfig(**tcfg), device="cpu",
                      init=params_from_numpy(shared_init, device="cpu"))
    jparams, _ = jtrain(JGemmaConfig.named("test", vocab_size=V), ref_corpus, JTrainConfig(**tcfg),
                        init=jax.tree.map(jnp.asarray, shared_init))
    init = _np(shared_init)
    for k, v in _np(params).items():
        np.testing.assert_array_equal(v, init[k], err_msg=k)
    for k, v in _np(jax.tree.map(np.asarray, jparams)).items():
        np.testing.assert_array_equal(v, init[k], err_msg=k)


@pytest.mark.parametrize("steps,warmup", [(12, 3), (2000, 100), (5, 0), (3, 5)])
def test_schedule_is_optax_warmup_cosine(steps, warmup):
    sched = lr_schedule(TrainConfig(steps=steps, warmup_steps=warmup, lr=3e-3))
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-3, warmup, max(steps, warmup + 1))
    for count in sorted({0, 1, 2, warmup - 1, warmup, warmup + 1, steps // 2, steps - 1, steps, steps + 3}):
        if count >= 0:
            assert sched(count) == pytest.approx(float(ref(count)), rel=1e-6, abs=1e-12), count
    if warmup:
        assert sched(0) == 0.0


@pytest.mark.parametrize("scale", [10.0, 0.01], ids=["clipped", "kept"])
def test_clip_by_global_norm_is_optax(scale):
    """``g / ‖g‖ · clip`` when ``‖g‖ >= clip`` (no epsilon), ``g`` as it is
    otherwise, against optax's ``clip_by_global_norm``."""
    rng = np.random.default_rng(7)
    grads = {"a": rng.standard_normal((5, 7), np.float32) * scale, "b": rng.standard_normal(11, np.float32) * scale}
    want, _ = optax.clip_by_global_norm(1.0).update(jax.tree.map(jnp.asarray, grads), optax.EmptyState())
    got = [torch.from_numpy(grads["a"].copy()), torch.from_numpy(grads["b"].copy())]
    _clip_by_global_norm(got, 1.0)
    norm = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values())))
    assert (norm >= 1.0) == (scale > 1)
    for t, k in zip(got, "ab"):
        if scale < 1:
            np.testing.assert_array_equal(t.numpy(), grads[k])
        np.testing.assert_allclose(t.numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)


def test_norm_leaves_are_not_decayed(corpora, shared_init):
    """With no target positions the gradients are 0, so an update is the
    decay alone: the norm scales stay bit for bit, every other leaf shrinks
    by (1 - lr·wd) a step, as the reference's mask does."""
    port_corpus, ref_corpus = corpora
    blank = dataclasses.replace(port_corpus, loss_mask=np.zeros_like(port_corpus.loss_mask))
    jblank = dataclasses.replace(ref_corpus, loss_mask=np.zeros_like(ref_corpus.loss_mask))
    init = {**shared_init, "final_norm": shared_init["final_norm"] + 0.5,
            "layers": {**shared_init["layers"], "pre_attn_norm": shared_init["layers"]["pre_attn_norm"] + 0.25}}
    tcfg = dict(steps=4, batch_size=8, warmup_steps=1, log_every=1, lr=0.5, weight_decay=0.1)
    params, report = train(GemmaConfig.named("test", vocab_size=V), blank, TrainConfig(**tcfg), device="cpu",
                           init=params_from_numpy(init, device="cpu"))
    jparams, _ = jtrain(JGemmaConfig.named("test", vocab_size=V), jblank, JTrainConfig(**tcfg),
                        init=jax.tree.map(jnp.asarray, init))
    assert report["first_loss"] == 0.0
    got, want, start = _np(params), _np(jax.tree.map(np.asarray, jparams)), _np(init)
    for k in start:
        if "norm" in k:
            np.testing.assert_array_equal(got[k], start[k], err_msg=k)
        else:
            assert np.abs(got[k]).sum() < 0.99 * np.abs(start[k]).sum(), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_train_forward_logits_equal_prefill():
    """The cache-free training forward gives ``prefill``'s logits over a
    fresh cache of exactly ``T`` slots (padded rows masked alike), and it
    differentiates."""
    cfg = GemmaConfig(vocab_size=384, d_model=64, n_layers=3, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96,
                      dtype="float32")
    params, _ = load_or_init(cfg, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, 384, (3, 24), generator=gen)
    lens = torch.tensor([24, 9, 1])
    logits = tm.train_forward(params, cfg, tokens, lens)
    ref, _ = tm.prefill(params, cfg, tokens, lens, tm.init_kv_cache(cfg, 3, 24, device="cpu"))
    assert logits.shape == (3, 24, 384)
    torch.testing.assert_close(logits, ref, rtol=0, atol=1e-6)
    leaf = params["layers"]["wq"].clone().requires_grad_(True)
    loss = tm.train_forward({**params, "layers": {**params["layers"], "wq": leaf}}, cfg, tokens, lens).square().mean()
    loss.backward()
    assert leaf.grad is not None and bool(torch.isfinite(leaf.grad).all()) and float(leaf.grad.abs().sum()) > 0


def test_train_reduces_loss_from_random_init(corpora):
    """The reference's 25-step test (``test_train_reduces_loss_and_roundtrips_npz``)
    from the port's own random init."""
    params, report = train(GemmaConfig.named("test", vocab_size=V), corpora[0],
                           TrainConfig(steps=25, batch_size=8, warmup_steps=5, log_every=0), device="cpu")
    assert report["final_loss"] < report["first_loss"] * 0.7, report
    assert report["loss_log"] == [] and 0.0 <= report["eval_token_accuracy"] <= 1.0


def test_npz_files_read_bit_equal_across_packages(tmp_path, shared_init):
    """A file each package writes, the other reads bit for bit (bfloat16
    under ``bf16:`` keys, and float32); the committed checkpoint survives
    the port's load and save exactly."""
    params = params_from_numpy(shared_init, device="cpu")
    for dtype in ("bfloat16", "float32"):
        port, ref = tmp_path / f"port-{dtype}.npz", tmp_path / f"ref-{dtype}.npz"
        save_npz(str(port), params, dtype=dtype)
        jsave_npz(str(ref), jax.tree.map(jnp.asarray, shared_init), dtype=dtype)
        with np.load(port) as a, np.load(ref) as b:
            assert a.files == b.files
            for k in a.files:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        from_ref = flatten_params(load_npz(str(ref), device="cpu"))
        from_port = jax.tree.map(np.asarray, jload_npz(str(port)))
        for k, v in flatten_params(from_port).items():
            t = from_ref[k]
            assert np.asarray(v).dtype.name == dtype and t.dtype == tm.torch_dtype(dtype), k
            bits = (t.view(torch.int16).numpy().view(np.uint16) if dtype == "bfloat16" else t.numpy())
            np.testing.assert_array_equal(np.asarray(v).view(bits.dtype), bits, err_msg=k)
    again = tmp_path / "again.npz"
    save_npz(str(again), load_npz(CKPT, device="cpu"))
    with np.load(CKPT) as a, np.load(again) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert unflatten_params(flatten_params(params)).keys() == params.keys()


def test_checkpoint_that_does_not_fit_is_refused(tmp_path):
    """A test-preset checkpoint at vocab 384 loaded for vocab 3072."""
    params, _ = load_or_init(GemmaConfig.named("test", vocab_size=384), seed=0, device="cpu")
    path = tmp_path / "ck.npz"
    save_npz(str(path), params)
    with pytest.raises(EngineError, match="does not fit"):
        load_or_init(GemmaConfig.named("test", vocab_size=3072), str(path), device="cpu")


def _assert_same_run(report, params, jreport, jparams):
    """The parity test's tolerances: every step's loss within 1e-5
    relative, the weights within 1e-4, the eval token accuracy equal."""
    assert [s for s, _ in report["loss_log"]] == [s for s, _ in jreport["loss_log"]]
    for (_, a), (_, b) in zip(report["loss_log"], jreport["loss_log"]):
        assert abs(a - b) <= 1e-5 * abs(b), (report["loss_log"], jreport["loss_log"])
    assert report["eval_token_accuracy"] == jreport["eval_token_accuracy"]
    got, want = _np(params), _np(jparams)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)


def test_mesh_is_refused(corpora, shared_init):
    """Served since the parallel package: ``train(mesh=data 2)`` on a virtual
    CPU mesh matches the reference's ``train(mesh=make_mesh(data=2,
    model=1))`` and the port's ``mesh=None`` step for step (each batch split
    in two, each half's loss over the whole batch's mask sum)."""
    from mcpx.parallel.mesh import make_mesh as jmake_mesh
    from mcpx_torch.parallel.mesh import make_mesh

    port_corpus, ref_corpus = corpora
    tcfg = dict(steps=6, batch_size=8, warmup_steps=2, log_every=1)
    jparams, jreport = jtrain(JGemmaConfig.named("test", vocab_size=V), ref_corpus, JTrainConfig(**tcfg),
                              init=jax.tree.map(jnp.asarray, shared_init), mesh=jmake_mesh(data=2, model=1))
    meshed, report = train(GemmaConfig.named("test", vocab_size=V), port_corpus, TrainConfig(**tcfg),
                           device="cpu", init=params_from_numpy(shared_init, device="cpu"),
                           mesh=make_mesh(data=2, devices=["cpu"] * 2))
    plain, plain_report = train(GemmaConfig.named("test", vocab_size=V), port_corpus, TrainConfig(**tcfg),
                                device="cpu", init=params_from_numpy(shared_init, device="cpu"))
    _assert_same_run(report, meshed, jreport, jax.tree.map(np.asarray, jparams))
    _assert_same_run(report, meshed, plain_report, plain)


@pytest.mark.parametrize("batch", [8, 6], ids=["divides", "drops_data"])
def test_hybrid_mesh_trains_as_a_flat_one(corpora, shared_init, batch):
    """The reference's hybrid recipe (``tests/test_sharding.py``): a
    (dcn_data 2, data 2, model 2) mesh against a flat data-8 one, and against
    the reference's hybrid run. At batch 6 the per-axis rule keeps the
    dcn_data split (6 % 2) and drops data (6 % 4), and the flat mesh does not
    split at all (6 % 8)."""
    from mcpx.parallel.mesh import make_hybrid_mesh as jmake_hybrid_mesh
    from mcpx_torch.models.train import _batch_shards
    from mcpx_torch.parallel.mesh import make_hybrid_mesh, make_mesh

    port_corpus, ref_corpus = corpora
    tcfg = dict(steps=4, batch_size=batch, warmup_steps=1, log_every=1)
    cpu8 = ["cpu"] * 8
    hybrid, flat = make_hybrid_mesh(2, 2, 2, devices=cpu8), make_mesh(data=8, devices=cpu8)
    assert len(_batch_shards(hybrid, batch)) == (4 if batch == 8 else 2)
    assert len(_batch_shards(flat, batch)) == (8 if batch == 8 else 1)
    runs = [train(GemmaConfig.named("test", vocab_size=V), port_corpus, TrainConfig(**tcfg), device="cpu",
                  init=params_from_numpy(shared_init, device="cpu"), mesh=m) for m in (hybrid, flat)]
    jparams, jreport = jtrain(JGemmaConfig.named("test", vocab_size=V), ref_corpus, JTrainConfig(**tcfg),
                              init=jax.tree.map(jnp.asarray, shared_init), mesh=jmake_hybrid_mesh(2, 2, 2))
    (h_params, h_report), (f_params, f_report) = runs
    _assert_same_run(h_report, h_params, f_report, f_params)
    _assert_same_run(h_report, h_params, jreport, jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("devices", [["cpu", "meta"], ["meta", "meta"]], ids=["meta_beside", "meta_only"])
def test_a_mesh_of_another_device_is_refused(corpora, devices):
    """A mesh naming ``meta``, which holds no data, raises before any
    step."""
    from mcpx_torch.parallel.mesh import make_mesh

    with pytest.raises(EngineError, match="device meta holds no data"):
        train(GemmaConfig.named("test", vocab_size=V), corpora[0], TrainConfig(steps=1, batch_size=2),
              device="cpu", mesh=make_mesh(data=2, devices=devices))
