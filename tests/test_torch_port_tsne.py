"""The port's t-SNE (``act_tpu_torch/utils/tsne.py``) and t-SNE runner
(``act_tpu_torch/engine/runner_tsne.py``) against scikit-learn's pieces and
the JAX package's ``runner_tsne`` on the CPU.

P against ``_joint_probabilities_nn`` on the same cosine neighbour graph, the
KL and its gradient against ``_kl_divergence``, both optimisation stages
against ``_gradient_descent`` (driven by the exact ``_kl_divergence``), the
whole embedding against JAX's ``_embed`` (scikit-learn's Barnes-Hut
``TSNE``), ``extract_features`` and ``tsne_net`` against JAX's on bridged
weights.
"""
import numpy as np
import pytest
import torch
from scipy.sparse import csr_array
from scipy.spatial.distance import squareform
from sklearn.manifold import _t_sne
from sklearn.metrics import silhouette_score
from sklearn.neighbors import NearestNeighbors

from act_tpu_torch.utils import tsne
from act_tpu_torch.utils.config import ConfigDict

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)

N = 60


def features(n=N, d=16, seed=0, equal_rows=0):
    """(n, d) f32 features in 4 loose clusters; the first ``equal_rows`` rows
    all equal (a collapsed set: cosine distances of exactly 0)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, d)) * 3.0
    x = centers[np.arange(n) % 4] + rng.normal(size=(n, d))
    x[:equal_rows] = x[0]
    return x.astype(np.float32)


def sklearn_graph(sqd, idx):
    """The port's neighbour graph as the CSR matrix ``_fit`` hands to
    ``_joint_probabilities_nn``."""
    n, k = sqd.shape
    return csr_array((sqd.ravel(), idx.ravel(), np.arange(0, n * k + 1, k)), shape=(n, n))


@pytest.mark.parametrize("equal_rows", [0, 20, N])
def test_joint_probabilities_match_sklearn(equal_rows):
    """P within 1e-6 of ``_joint_probabilities_nn`` on the port's cosine graph
    in f32, with a set of 20 equal rows and with every row equal (rows whose
    search cannot reach the perplexity; with every row equal the rounded
    distances of ~1e-14 underflow at the search's last precision, and P is 0
    on both sides); P finite and symmetric, of sum 1 unless collapsed."""
    x = features(equal_rows=equal_rows)
    perp = tsne.default_perplexity(N)
    k = min(N - 1, int(3 * perp + 1))
    dist, idx = tsne.cosine_knn(torch.from_numpy(x), k)
    sqd = (dist * dist).numpy()
    got = tsne.joint_probabilities_nn(dist * dist, idx, perp).to(torch.float32).numpy()
    want = _t_sne._joint_probabilities_nn(sklearn_graph(sqd, idx.numpy()), perp, 0)
    want = np.asarray(want.todense(), np.float32)
    assert np.isfinite(got).all() and np.array_equal(got, got.T)
    if equal_rows < N:
        assert abs(float(got.astype(np.float64).sum()) - 1.0) < 1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_cosine_graph_matches_sklearn():
    """The neighbour graph equals scikit-learn's ``NearestNeighbors(metric=
    "cosine").kneighbors_graph(mode="distance")`` (distances within 1e-6,
    the same neighbours) on rows without ties."""
    x = features(seed=1)
    k = 20
    dist, idx = tsne.cosine_knn(torch.from_numpy(x), k)
    g = NearestNeighbors(n_neighbors=k, metric="cosine").fit(x).kneighbors_graph(mode="distance")
    g.sort_indices()
    want_idx = g.indices.reshape(N, k)
    order = np.argsort(idx.numpy(), axis=1)
    np.testing.assert_array_equal(np.take_along_axis(idx.numpy(), order, 1), want_idx)
    np.testing.assert_allclose(np.take_along_axis(dist.numpy(), order, 1),
                               g.data.reshape(N, k), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kl_divergence_matches_sklearn(dtype):
    """The KL and its gradient within 1e-6 (relative; the gradient relative
    to its largest entry) of ``_kl_divergence`` at the same P and Y."""
    x = features(seed=2)
    perp = tsne.default_perplexity(N)
    dist, idx = tsne.cosine_knn(torch.from_numpy(x), min(N - 1, int(3 * perp + 1)))
    p = tsne.joint_probabilities_nn(dist * dist, idx, perp)
    y = np.random.default_rng(3).normal(size=(N, 2)) * 2.0
    kl_w, grad_w = _t_sne._kl_divergence(y.ravel(), squareform(p.numpy(), checks=False), 1, N, 2)
    kl, grad = tsne.kl_divergence(torch.tensor(y, dtype=dtype), p.to(dtype))
    assert abs(float(kl) - kl_w) <= 1e-6 * abs(kl_w)
    grad_w = grad_w.reshape(N, 2)
    assert np.abs(grad.double().numpy() - grad_w).max() <= 1e-6 * np.abs(grad_w).max()


def sklearn_descent(y0, pc, it, max_iter, momentum, lr, **kw):
    y, kl, it = _t_sne._gradient_descent(
        _t_sne._kl_divergence, y0.ravel().copy(), it, max_iter, n_iter_check=50,
        momentum=momentum, learning_rate=lr, args=[pc, 1, N, 2], **kw)
    return y.reshape(N, 2), kl, it


# (first iteration, last + 1, momentum, exaggeration, stop rule): short runs,
# since the exaggerated stage amplifies a rounding difference ~1.8x an
# iteration (1e-19 at iteration 1, 8e-11 at 20, 0.04 at 50, in f64), so that
# longer runs of either implementation end in other local optima; the final
# stage is calmer, and its first check (iteration 299) takes the gradient
# norm stop
STAGES = {
    "exploration": (0, 20, 0.5, 12.0, {"n_iter_without_progress": 250}),
    "final": (250, 280, 0.8, 1.0, {"n_iter_without_progress": 300}),
    "grad_norm_stop": (250, 1000, 0.8, 1.0, {"n_iter_without_progress": 300,
                                             "min_grad_norm": 1e3}),
}


@pytest.mark.parametrize("stage", list(STAGES))
def test_gradient_descent_matches_sklearn(stage):
    """Each stage of the optimiser from the same point at N = 60, in f64,
    against ``_gradient_descent`` on the exact ``_kl_divergence``: the
    exaggerated stage at momentum 0.5 from the PCA init, the final stage at
    momentum 0.8 from iteration 250 (gains and momentum from rest), and its
    stop at a gradient norm under ``min_grad_norm``. The embedding within 1e-9 of its
    spread, the last error within 1e-9 relative, the same last iteration."""
    first, end, momentum, exaggeration, kw = STAGES[stage]
    x = features(seed=4)
    perp = tsne.default_perplexity(N)
    dist, idx = tsne.cosine_knn(torch.from_numpy(x), min(N - 1, int(3 * perp + 1)))
    p = tsne.joint_probabilities_nn(dist * dist, idx, perp)
    pc = squareform(p.numpy(), checks=False)
    lr = max(N / 12 / 4, 50.0)
    y0 = tsne.pca_init(torch.from_numpy(x)).double().numpy()
    if first:  # the final stage starts where scikit-learn's exploration ended
        y0 = sklearn_descent(y0, pc * 12.0, 0, 250, 0.5, lr, n_iter_without_progress=250)[0]
    want, kl_w, it_w = sklearn_descent(y0, pc * exaggeration, first, end, momentum, lr, **kw)
    y, kl, it = tsne.gradient_descent(torch.from_numpy(y0), p * exaggeration, first, end,
                                      momentum, lr, **kw)
    assert it == it_w, (it, it_w)
    assert (it < end - 1) if "stop" in stage else (it == end - 1), it
    assert np.abs(y.numpy() - want).max() <= 1e-9 * want.std()
    assert abs(kl - kl_w) <= 1e-9 * kl_w


def test_pca_init_sign_rule():
    """The init equals scikit-learn's PCA projection (full solver) with
    ``svd_flip``'s signs, scaled to a column-0 std of 1e-4; a constant
    column 0 stays finite."""
    from sklearn.decomposition import PCA

    x = features(seed=5)
    want = PCA(n_components=2, svd_solver="full").fit_transform(x).astype(np.float32)
    want = want / np.std(want[:, 0]) * 1e-4
    got = tsne.pca_init(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * 1e-4)
    assert np.isfinite(tsne.pca_init(torch.ones(8, 4))).all()


# JAX's _embed (scikit-learn's Barnes-Hut TSNE) may land its exact KL this
# far below the port's exact optimum; measured 0.006 at this set
KL_MARGIN = 0.05


def test_embed_against_jax_embed():
    """The whole ``embed`` against JAX's ``runner_tsne._embed`` on the
    6-cluster set of ``tests/test_engine.py::TestTsneDual::
    test_embedding_separates_classes``: both silhouettes > 0.5, and the
    port's exact KL at most ``KL_MARGIN`` above the exact KL of scikit-
    learn's embedding at the same P. Two runs give the same embedding."""
    from act_tpu.engine.runner_tsne import _embed

    rng = np.random.default_rng(0)
    n_cls, per = 6, 40
    centers = rng.normal(size=(n_cls, 32)) * 8.0
    feats = np.concatenate([centers[c] + rng.normal(size=(per, 32)) * 0.3
                            for c in range(n_cls)]).astype(np.float32)
    labels = np.repeat(np.arange(n_cls), per)
    got = tsne.embed(feats, device="cpu")
    want = _embed(feats)
    assert got.y.shape == want.shape == (n_cls * per, 2)
    assert silhouette_score(got.y, labels) > 0.5
    assert silhouette_score(want, labels) > 0.5
    n = len(feats)
    dist, idx = tsne.cosine_knn(torch.from_numpy(feats), min(n - 1, int(3 * got.perplexity + 1)))
    p = tsne.joint_probabilities_nn(dist * dist, idx, got.perplexity)
    kl_port = float(tsne.kl_divergence(torch.from_numpy(got.y).double(), p)[0])
    kl_sk = float(tsne.kl_divergence(torch.from_numpy(want).double(), p)[0])
    assert abs(kl_port - got.kl) <= 1e-4 * kl_port
    assert kl_port <= kl_sk + KL_MARGIN, (kl_port, kl_sk)
    np.testing.assert_array_equal(tsne.embed(feats, device="cpu").y, got.y)


# ---------------------------------------------------------------------------
# the runner against JAX's runner_tsne
# ---------------------------------------------------------------------------

RUN_NPOINTS, RUN_BS = 64, 20
RUN_MODEL = dict(NAME="PointTransformer", embed_dim=32, depth=1, drop_path_rate=0.0, cls_dim=2,
                 num_heads=2, group_size=8, num_group=8, encoder_dims=32, transfer_type="full")


def run_config(cfg_cls, **extra):
    """The t-SNE config on the synthetic 2-way few-shot test split (20
    clouds a class, in class order): two batches of 20 hold both classes,
    so that even a constant prediction gets 20 clouds right."""
    node = {"_base_": dict(NAME="ModelNetFewShot", DATA_PATH="data/absent", N_POINTS=96,
                           way=2, shot=10, fold=0),
            "others": {"subset": "test", "npoints": RUN_NPOINTS, "bs": RUN_BS}}
    return cfg_cls(dict(dataset=dict(test=node), model_pretrained=dict(RUN_MODEL),
                        model_finetuned=dict(RUN_MODEL), npoints=RUN_NPOINTS,
                        total_bs=RUN_BS, **extra))


@pytest.fixture(scope="module")
def jax_tsne(tmp_path_factory):
    """JAX's ``tsne_net`` on the config (its weights from its init at seed 0,
    the vote leg and the plots replaced by recorders, sklearn's embedding
    kept), with what its ``extract_features`` returned and its log lines;
    and those weights as reference ``.pth`` files for the port."""
    from act_tpu.engine import runner_finetune as jrf
    from act_tpu.engine import runner_tsne as jrt
    from act_tpu.utils.config import ConfigDict as JConfigDict

    from act_tpu_torch.engine import weights

    out = tmp_path_factory.mktemp("jax_tsne")
    rec = {"extract": [], "log": [], "vote": 0}
    extract = jrt.extract_features

    def record_extract(*a, **kw):
        r = extract(*a, **kw)
        rec["extract"].append(r)
        return r

    def record_vote(*a, **kw):
        rec["vote"] += 1
        return 0.0

    cfg = run_config(JConfigDict)
    args = type("A", (), dict(log_name=None, experiment_path=str(out), seed=0, ckpts=None,
                              distributed=False))()
    # both models of the config are the same, and JAX builds each from its init at the seed
    built = jrt._build_and_load(cfg.model_finetuned, None, RUN_NPOINTS, 0, None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrt, "_build_and_load", lambda *a: built)
        mp.setattr(jrt, "extract_features", record_extract)
        mp.setattr(jrt, "print_log", lambda msg, logger=None: rec["log"].append(msg))
        mp.setattr(jrt, "_plot", lambda emb, labels, path, logger: None)
        mp.setattr(jrf, "validate_vote", record_vote)
        jrt.tsne_net(args, cfg, max_batches=2)
    v = built[1]
    pth = str(out / "jax_init.pth")
    torch.save(weights.flax_to_state_dict(v["params"], v["batch_stats"]), pth)
    return rec, pth


def test_extract_features_matches_jax(jax_tsne):
    """The port's ``extract_features`` (FPS resample 64 -> 64, which still
    walks, then ``extract_feature`` and the logits) on JAX's weights through
    the bridge: features and logits within 1e-5 of JAX's, the same labels
    and logits argmax."""
    from act_tpu_torch.engine import builder, runner_tsne

    rec, pth = jax_tsne
    jfeats, jlogits, jlabels = rec["extract"][1]  # the finetuned model, with logits
    cfg = run_config(ConfigDict)
    model = runner_tsne._build_and_load(cfg.model_finetuned, pth, RUN_NPOINTS, 0, "cpu")
    _, loader = builder.dataset_builder(cfg.dataset.test, 0)
    batches = [b for _, b in zip(range(2), loader)]
    feats, logits, labels = runner_tsne.extract_features(model, batches, RUN_NPOINTS,
                                                         with_logits=True)
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_allclose(feats, jfeats, rtol=0, atol=1e-5)
    np.testing.assert_allclose(logits, jlogits, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(logits.argmax(-1), jlogits.argmax(-1))


def test_tsne_net_dual_matches_jax(jax_tsne, tmp_path, monkeypatch):
    """The port's ``tsne_net`` on the same data and bridged weights: the same
    OA, mAcc (the JAX runner's log line) and correct set, both ``.npz``
    embeddings written for the correct clouds, and the 2-round vote leg run
    through ``test_vote_rounds``."""
    from act_tpu_torch.engine import runner_tsne

    rec, pth = jax_tsne
    jlog = next(m for m in rec["log"] if m.startswith("[TEST]"))
    _, jlogits, jlabels = rec["extract"][1]
    jcorrect = jlogits.argmax(-1) == jlabels
    assert jcorrect.sum() >= runner_tsne.MIN_CORRECT and rec["vote"] == 2
    log, rounds = [], []
    monkeypatch.setattr(runner_tsne, "print_log", lambda msg, logger=None: log.append(msg))
    vote = runner_tsne.test_vote_rounds
    monkeypatch.setattr(runner_tsne, "test_vote_rounds",
                        lambda *a, **kw: rounds.append(a[4]) or vote(*a, **kw))
    args = type("A", (), dict(log_name=None, experiment_path=str(tmp_path), seed=0,
                              ckpts=None, device="cpu"))()
    emb_p, emb_f = runner_tsne.tsne_net(
        args, run_config(ConfigDict, ckpt_pretrained=pth, ckpt_finetuned=pth), max_batches=2)
    assert next(m for m in log if m.startswith("[TEST]")) == jlog
    assert rounds == [2] and any(m.startswith("[TEST_VOTE]") for m in log)
    for name, emb in (("pretrained", emb_p), ("finetuned", emb_f)):
        saved = np.load(tmp_path / f"tsne_{name}.npz")
        np.testing.assert_array_equal(saved["labels"], jlabels[jcorrect])
        assert saved["embedding"].shape == (int(jcorrect.sum()), 2)
        np.testing.assert_array_equal(saved["embedding"], emb)
        assert np.isfinite(emb).all()


def test_tsne_entry_points_default_to_the_card():
    """``embed`` and the CLI raise without a card unless the CPU is asked
    for; an orbax checkpoint name raises."""
    from act_tpu_torch import main_tsne
    from act_tpu_torch.engine import runner_tsne

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tsne.embed(features())
    with pytest.raises(RuntimeError, match="cuda"):
        main_tsne.main(["--config", "cfgs/tsne/tsne_scan_hardest.yaml"])
    with pytest.raises(ValueError, match="orbax"):
        runner_tsne._build_and_load(RUN_MODEL, "model_zoo/ckpt.orbax", RUN_NPOINTS, 0, "cpu")
