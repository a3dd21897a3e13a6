"""The port's TabPFN against the JAX package's and against a torch replica of
the reference module (CPU), at emsize 32, 4 heads, nhid 64, 2 layers and
10 features (tests/test_tabpfn.py's sizes).

The attention mask and the inlier mask of ``_preprocess`` (with its
un-centred +-2 sigma band) are equal to JAX's bit for bit; ``_preprocess``'s
values are within rtol 2e-6, atol 2e-6 (torch and XLA sum the train-row
statistics in another order and round ``log1p`` and ``sqrt`` differently,
by an ulp). ``TabPFNTransformer`` from converted JAX weights: logits and
the ``decoder`` tap within rtol 1e-5, atol 1e-5 in float32; in bfloat16
within twice JAX's own bf16-vs-f32 distance of JAX's f32 result
(tests/test_torch_dtype.py). From a replica's state dict through
``convert_state_dict`` (tabpfn's layout): within rtol 2e-5, atol 2e-5 of
the replica, as tests/test_tabpfn.py holds JAX. ``TabPFNClassifier``: the
members' mean probabilities and embeddings within 1e-5 of JAX's, and a
refit with another class count recomputes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu.models.tabular_models import tabpfn as jax_tabpfn
from multimodal_alzheimer_tpu_torch.data.dataset import (
    MultiModalDataset,
    TabularEmbeddingDataset,
)
from multimodal_alzheimer_tpu_torch.data.pipeline import DataLoader
from multimodal_alzheimer_tpu_torch.data.synthetic import (
    write_synthetic_split,
)
from multimodal_alzheimer_tpu_torch.models.convert import state_dict_from_flax
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabpfn import (
    TabPFNClassifier,
    TabPFNTransformer,
    _preprocess,
    convert_state_dict,
    inlier_mask,
    model_from_state_dict,
    pfn_attention_mask,
)
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabular_mlp import (
    TabularMLP,
)
from multimodal_alzheimer_tpu_torch.parallel import Mesh
from multimodal_alzheimer_tpu_torch.parallel.launch import run_ranks
from test_tabpfn import EMSIZE, NFEAT, NHEAD, NHID, NLAYERS, TorchTabPFN
from torch_dp_ranks import tabpfn_on_ranks
from torch_port_helpers import dist, random_variables
from torch_threads import torch_threads  # noqa: F401 (autouse)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
PRE_TOL = dict(rtol=2e-6, atol=2e-6)
REPLICA_TOL = dict(rtol=2e-5, atol=2e-5)
SIZES = dict(emsize=EMSIZE, nhead=NHEAD, nhid=NHID, nlayers=NLAYERS,
             max_features=NFEAT)


def _jax_model(dtype=jnp.float32):
    return jax_tabpfn.TabPFNTransformer(dtype=dtype, **SIZES)


@pytest.fixture(scope="module")
def weights():
    """(numpy flax variables, the port's state dict of them)."""
    variables = random_variables(_jax_model(), 0,
                                 jnp.zeros((3, NFEAT)), jnp.zeros((1,)), 1)
    return variables, state_dict_from_flax(variables, TabPFNTransformer(
        **SIZES))


def _port(state_dict, dtype=torch.float32):
    model = TabPFNTransformer(dtype=dtype, **SIZES)
    model.load_state_dict(state_dict)
    return model.eval()


def _seq(seed, n=14, n_train=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, NFEAT)).astype(np.float32)
    y = rng.integers(0, 3, n_train).astype(np.float32)
    return x, y, n_train


@pytest.mark.parametrize("seq_len,n_train", [(4, 2), (9, 9), (12, 5)])
def test_attention_mask_equals_jax(seq_len, n_train):
    got = pfn_attention_mask(seq_len, n_train).numpy()
    want = np.asarray(jax_tabpfn.pfn_attention_mask(seq_len, n_train))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)  # -inf where masked


@pytest.mark.parametrize("seed", range(3))
def test_preprocess_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(3.0, 2.0, (40, 6)).astype(np.float32)
    x[rng.integers(0, 30, 4), rng.integers(0, 6, 4)] = 40.0  # outliers
    x[:, 5] = x[:, 5] ** 3  # a skewed feature
    want = np.asarray(jax_tabpfn._preprocess(jnp.asarray(x), 30, 6, NFEAT))
    got = _preprocess(torch.from_numpy(x), 30, 6, NFEAT).numpy()
    assert got.shape == want.shape == (40, NFEAT)
    np.testing.assert_allclose(got, want, **PRE_TOL)
    np.testing.assert_array_equal(got[:, 6:], 0.0)
    # the same members batched on a leading axis
    batched = _preprocess(torch.from_numpy(np.stack([x, x[:, ::-1].copy()])),
                          30, 6, NFEAT).numpy()
    np.testing.assert_array_equal(batched[0], got)


def test_inlier_mask_is_the_uncentred_band():
    """JAX's test, inside _preprocess (tabpfn.py:209): |x| <= 2 std, not
    |x - mean| <= 2 std. On a feature of mean 5, std 1 the two differ."""
    rng = np.random.default_rng(7)
    tr = rng.normal(0.0, 1.0, (50, 3)).astype(np.float32)
    tr[:, 1] += 5.0
    t = jnp.asarray(tr)
    sd = t.std(0, ddof=1)
    want = np.asarray((t >= -2.0 * sd) & (t <= 2.0 * sd))
    got = inlier_mask(torch.from_numpy(tr)).numpy()
    np.testing.assert_array_equal(got, want)
    centred = np.abs(tr - tr.mean(0)) <= 2.0 * tr.std(0, ddof=1)
    assert not got[:, 1].any() and centred[:, 1].mean() > 0.9


@pytest.mark.parametrize("seed", range(2))
def test_transformer_matches_jax(weights, seed):
    variables, state_dict = weights
    x, y, n_train = _seq(seed)
    want = _jax_model().apply(variables, x, y, n_train)
    with torch.no_grad():
        got = _port(state_dict)(torch.from_numpy(x), torch.from_numpy(y),
                                n_train)
    assert got["logits"].shape == (len(x) - n_train, 10)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), **F32_TOL)
    np.testing.assert_allclose(got["embeddings"]["decoder"].numpy(),
                               np.asarray(want["embeddings"]["decoder"]),
                               **F32_TOL)


@pytest.mark.parametrize("seed", range(2))
def test_bf16_transformer_matches_jax(weights, seed):
    """bf16 compute, f32 params: logits and decoder tap within twice JAX's
    own bf16-vs-f32 distance of JAX's f32 result; both float32."""
    variables, state_dict = weights
    x, y, n_train = _seq(seed + 10)
    want = {dt: _jax_model(dt).apply(variables, x, y, n_train)
            for dt in (jnp.float32, jnp.bfloat16)}
    with torch.no_grad():
        got = _port(state_dict, torch.bfloat16)(
            torch.from_numpy(x), torch.from_numpy(y), n_train)
    for name, g, w32, w16 in (
            ("logits", got["logits"], want[jnp.float32]["logits"],
             want[jnp.bfloat16]["logits"]),
            ("decoder", got["embeddings"]["decoder"],
             want[jnp.float32]["embeddings"]["decoder"],
             want[jnp.bfloat16]["embeddings"]["decoder"])):
        assert g.dtype == torch.float32 and w16.dtype == jnp.float32
        ref = dist(w16, w32)
        assert dist(g.numpy(), w32) <= 2 * ref, (name, dist(g, w32), ref)


@pytest.fixture(scope="module")
def replica():
    torch.manual_seed(0)
    return TorchTabPFN().eval()


def test_convert_state_dict_matches_the_replica(replica):
    """tabpfn's layout -> the port: logits and the decoder[0] hook."""
    converted = convert_state_dict(replica.state_dict())
    model = model_from_state_dict(converted)
    assert (model.emsize, model.nhead, model.nhid, model.nlayers,
            model.n_out, model.max_features) == (EMSIZE, 4, NHID, NLAYERS,
                                                 10, NFEAT)
    model.load_state_dict(converted)
    model.eval()
    x, y, n_train = _seq(3)
    acts = {}
    handle = replica.decoder[0].register_forward_hook(
        lambda m, i, o: acts.__setitem__("dec", o.detach()))
    with torch.no_grad():
        want = replica(torch.from_numpy(x), torch.from_numpy(y), n_train)
        got = model(torch.from_numpy(x), torch.from_numpy(y), n_train)
    handle.remove()
    np.testing.assert_allclose(got["logits"].numpy(), want.numpy(),
                               **REPLICA_TOL)
    np.testing.assert_allclose(got["embeddings"]["decoder"].numpy(),
                               acts["dec"].numpy(), **REPLICA_TOL)
    # and JAX's converter gives the JAX model the same function
    jax_vars = jax_tabpfn.convert_state_dict(replica.state_dict())
    np.testing.assert_allclose(
        got["logits"].numpy(),
        np.asarray(_jax_model().apply(jax_vars, x, y, n_train)["logits"]),
        **F32_TOL)


def _classifiers(weights, **kw):
    variables, state_dict = weights
    jax_clf = jax_tabpfn.TabPFNClassifier(
        variables=jax.tree.map(jnp.asarray, variables), model=_jax_model(),
        **kw)
    port_clf = TabPFNClassifier(state_dict=state_dict,
                                model=TabPFNTransformer(**SIZES),
                                device="cpu", **kw)
    return jax_clf, port_clf


@pytest.mark.parametrize("n_classes,ensemble", [(2, 4), (3, 5)])
def test_classifier_matches_jax(weights, n_classes, ensemble):
    rng = np.random.default_rng(n_classes)
    x_tr = rng.normal(size=(24, 9)).astype(np.float32)
    y_tr = rng.integers(0, n_classes, 24) * 3  # labels {0, 3, 6}
    x_te = rng.normal(size=(7, 9)).astype(np.float32)
    jax_clf, port_clf = _classifiers(weights, ensemble_size=ensemble)
    jax_clf.fit(x_tr, y_tr)
    port_clf.fit(x_tr, y_tr)
    np.testing.assert_array_equal(port_clf.class_shifts.numpy(),
                                  np.asarray(jax_clf.class_shifts))
    np.testing.assert_array_equal(port_clf.feature_shifts.numpy(),
                                  np.asarray(jax_clf.feature_shifts))
    probs = port_clf.predict_proba(x_te)
    assert probs.shape == (7, n_classes)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(probs, jax_clf.predict_proba(x_te), **F32_TOL)
    np.testing.assert_allclose(port_clf.embed(x_te), jax_clf.embed(x_te),
                               **F32_TOL)
    pred, p = port_clf.predict(x_te, return_winning_probability=True)
    want_pred, want_p = jax_clf.predict(x_te, return_winning_probability=True)
    np.testing.assert_array_equal(pred, want_pred)
    np.testing.assert_allclose(p, want_p, **F32_TOL)


def test_classifier_rotations_and_test_row_independence(weights):
    """Explicit shifts, cut to the ensemble size as JAX cuts them; a test
    row's probabilities do not depend on the other test rows."""
    rng = np.random.default_rng(5)
    x_tr = rng.normal(size=(16, 4)).astype(np.float32)
    y_tr = np.arange(16) % 3
    x_te = rng.normal(size=(4, 4)).astype(np.float32)
    kw = dict(ensemble_size=2, class_shifts=[1, 2, 0],
              feature_shifts=[3, 1, 2])
    jax_clf, port_clf = _classifiers(weights, **kw)
    probs = port_clf.fit(x_tr, y_tr).predict_proba(x_te)
    assert port_clf.class_shifts.tolist() == [1, 2]
    np.testing.assert_allclose(probs, jax_clf.fit(x_tr, y_tr).predict_proba(
        x_te), **F32_TOL)
    np.testing.assert_allclose(port_clf.predict_proba(x_te[:1]), probs[:1],
                               rtol=1e-5, atol=1e-6)


def test_refit_with_another_class_count_recomputes(weights):
    """The JAX _forward caches its program on the classifier (tabpfn.py:281);
    the port recomputes: a refit to 3 classes answers as a fresh one."""
    rng = np.random.default_rng(8)
    x_tr = rng.normal(size=(18, 5)).astype(np.float32)
    x_te = rng.normal(size=(3, 5)).astype(np.float32)
    _, clf = _classifiers(weights, ensemble_size=3)
    assert clf.fit(x_tr, np.arange(18) % 2).predict_proba(x_te).shape == (3,
                                                                        2)
    refit = clf.fit(x_tr, np.arange(18) % 3).predict_proba(x_te)
    _, fresh = _classifiers(weights, ensemble_size=3)
    assert refit.shape == (3, 3)
    np.testing.assert_array_equal(
        refit, fresh.fit(x_tr, np.arange(18) % 3).predict_proba(x_te))


def test_random_prior_is_seeded():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(12, 3)).astype(np.float32)
    y = np.arange(12) % 2
    a, b, c = (TabPFNClassifier(model=TabPFNTransformer(**SIZES), seed=s,
                                device="cpu").fit(x, y).embed(x[:2])
               for s in (1, 1, 2))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c) and a.shape == (2, NHID)


def test_tabular_embedding_dataset_feeds_the_mlp(weights, tmp_path):
    """Embeddings computed once per row ride the loader into TabularMLP's
    pass-through; every other attribute is the base dataset's."""
    csvs = write_synthetic_split(str(tmp_path / "data"),
                                 n_subjects=(10, 2, 2), seed=9,
                                 volume_shape=(6, 7, 6), write_volumes=False)
    base = MultiModalDataset(path=csvs["train"], modalities=["tabular"],
                             binary_classification=True)
    x = np.stack([base[i]["tabular"] for i in range(len(base))])
    y = np.asarray([int(base[i]["label"]) for i in range(len(base))])
    _, clf = _classifiers(weights, ensemble_size=2)
    clf.fit(x, y)
    ds = TabularEmbeddingDataset.from_tabpfn(base, clf)
    assert ds.embeddings.shape == (len(base), NHID)
    assert ds.rows is base.rows and len(ds) == len(base)
    np.testing.assert_allclose(ds[0]["tabular_embedding"],
                               clf.embed(x[:1])[0], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="embeddings for"):
        TabularEmbeddingDataset(base, ds.embeddings[:-1])
    batch = next(iter(DataLoader(ds, batch_size=4, num_workers=1,
                                 device="cpu")))
    assert tuple(batch["tabular_embedding"].shape) == (4, NHID)
    mlp = TabularMLP(n_classes=2, hidden=(8, NHID)).eval()
    out = mlp(batch)
    torch.testing.assert_close(out["embeddings"]["decoder"],
                               batch["tabular_embedding"], rtol=0, atol=0)


def test_classifier_members_split_over_ranks(weights):
    """``mesh=``: two gloo ranks run two members each; the all-reduced
    probabilities and decoder tap are the unsharded ensemble's within
    1e-5. An ensemble that is not a multiple of the ranks is refused."""
    _, state_dict = weights
    rng = np.random.default_rng(9)
    fit = (rng.normal(size=(24, 9)).astype(np.float32),
           rng.integers(0, 3, 24))
    x_te = rng.normal(size=(7, 9)).astype(np.float32)
    ranks = run_ranks(tabpfn_on_ranks, 2, "gloo", state_dict, SIZES, fit,
                      x_te, 4, device="cpu", timeout=180)
    clf = TabPFNClassifier(state_dict=state_dict,
                           model=TabPFNTransformer(**SIZES),
                           ensemble_size=4, device="cpu").fit(*fit)
    for probs, embed in ranks:
        np.testing.assert_allclose(probs, clf.predict_proba(x_te), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(embed, clf.embed(x_te), rtol=0,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="not a multiple"):
        TabPFNClassifier(state_dict=state_dict, ensemble_size=3,
                         mesh=Mesh(None, 0, 2, torch.device("cpu"), "gloo"))
