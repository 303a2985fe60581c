"""The port's loss functions and loss layers against the reference's: the
same numpy inputs through ``paddle_tpu`` and ``paddle_tpu_torch`` (on the
CPU), the value and dtype, then the gradients of the floating inputs
(``tests/torch_op_test.py``: elementwise bounds ``TOL["ew"]``, reductions
``TOL["red"]``).  Covers every function of the reference's
``ops/loss.py`` and every layer of its ``nn/layer/loss.py``, with CTC on
an impossible alignment, ``hsigmoid_loss`` on the default and a custom
tree, ``margin_cross_entropy(return_softmax=True)`` and ``nce`` under each
sampler with a seed; and the twins of ``tests/test_optest_loss_creation.py``'s
loss cases and ``tests/test_nn_extras.py``'s loss tests."""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.core import place as port_place
from torch_op_test import TOL, numeric_grad_check, run_both

rs = np.random.RandomState(3)
f32 = np.float32
PRED = rs.rand(4, 5).astype(f32)
TGT = rs.rand(4, 5).astype(f32)
LOGITS = (rs.rand(4, 5) * 2 - 1).astype(f32)
LABELS = rs.randint(0, 5, (4,)).astype(np.int64)
LOGP = np.log(np.exp(LOGITS) / np.exp(LOGITS).sum(-1, keepdims=True)
              ).astype(f32)
PROBS = np.exp(LOGP).astype(f32)
SIGN = np.array([1., -1., 1., -1.], f32)
W5 = (rs.rand(5) + 0.5).astype(f32)
N3 = rs.randn(4, 6).astype(f32)
# CTC: (T, N, C) logits, labels right-padded; the third sequence cannot
# be aligned (3 labels in 2 frames): a large finite loss
CTC_LP = rs.randn(8, 3, 5).astype(f32)
CTC_LABELS = np.array([[1, 2, 2], [3, 4, 0], [1, 2, 3]], np.int32)
CTC_IL = np.array([8, 6, 2], np.int32)
CTC_LL = np.array([3, 2, 3], np.int32)
# the two that can be aligned: the impossible one's gradient sums terms of
# ~1e5 in fp32, where the two recursions' orders differ by ~6e-4
CTC_OK = (CTC_LP[:, :2], CTC_LABELS[:2], CTC_IL[:2], CTC_LL[:2])
# hsigmoid: 6 classes, 5 internal nodes; a custom tree of depth 3
HS_X = rs.randn(4, 8).astype(f32)
HS_Y = np.array([[0], [3], [5], [2]], np.int64)
HS_W = rs.randn(5, 8).astype(f32)
HS_B = rs.randn(5).astype(f32)
HS_TABLE = np.array([[0, 1, 3], [0, 1, 4], [0, 2, 3], [0, 2, 4],
                     [0, 1, 2], [0, 3, 4]], np.int64)
HS_CODE = np.array([[0, 0, 1], [0, 1, 1], [1, 0, 0], [1, 1, 1],
                    [0, 1, 0], [1, 0, 1]], np.int64)
DICE_P = PROBS.reshape(2, 2, 5)
DICE_Y = LABELS.reshape(2, 2, 1)
COS = (rs.rand(4, 10) * 2 - 1).astype(f32)
COS_Y = np.array([1, 3, 5, 7], np.int64)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    place = port_place._place
    port.set_device("cpu")
    was = ref.get_flags(["FLAGS_eager_jit_cache"])
    ref.set_flags({"FLAGS_eager_jit_cache": False})
    yield
    ref.set_flags(was)
    port_place._place = place


def F(name):
    return lambda m: getattr(m.nn.functional, name)


# (id, callable of a package, args, kwargs, grad inputs, tolerance)
CASES = [
    ("one_hot", F("one_hot"), (LABELS,), dict(num_classes=5), (), "ew"),
    ("mse", F("mse_loss"), (PRED, TGT), {}, (0, 1), "red"),
    ("mse_none", F("mse_loss"), (PRED, TGT), dict(reduction="none"),
     (0, 1), "ew"),
    ("square_error_cost", F("square_error_cost"), (PRED, TGT), {}, (0, 1),
     "ew"),
    ("l1_sum", F("l1_loss"), (PRED, TGT), dict(reduction="sum"), (0,),
     "red"),
    ("nll", F("nll_loss"), (LOGP, LABELS), {}, (0,), "red"),
    ("nll_weight_ignore", F("nll_loss"), (LOGP, np.array(
        [0, -100, 4, 2], np.int64), W5), dict(ignore_index=-100), (0,),
     "red"),
    ("nll_none", F("nll_loss"), (LOGP, LABELS), dict(reduction="none"),
     (0,), "ew"),
    ("bce", F("binary_cross_entropy"), (PROBS, TGT, PRED), {}, (0,), "red"),
    ("bce_logits", F("binary_cross_entropy_with_logits"),
     (LOGITS, TGT), {}, (0,), "red"),
    ("bce_logits_weights", lambda m: lambda z, y, w, pw:
     m.nn.functional.binary_cross_entropy_with_logits(
         z, y, w, reduction="sum", pos_weight=pw),
     (LOGITS, TGT, PRED, W5), {}, (0,), "red"),
    ("kl_div", F("kl_div"), (LOGP, PROBS), {}, (0, 1), "red"),
    ("kl_div_batchmean", F("kl_div"), (LOGP, PROBS),
     dict(reduction="batchmean"), (0,), "red"),
    ("smooth_l1", F("smooth_l1_loss"), (PRED, TGT), dict(delta=0.3), (0,),
     "red"),
    ("huber", F("huber_loss"), (PRED, TGT), dict(delta=0.3,
                                                  reduction="none"),
     (0,), "ew"),
    ("margin_ranking", F("margin_ranking_loss"), (PRED[:, 0], TGT[:, 0],
                                                  SIGN), dict(margin=0.1),
     (0, 1), "red"),
    ("hinge_embedding", F("hinge_embedding_loss"), (LOGITS[:, 0], SIGN), {},
     (0,), "red"),
    ("cosine_embedding", F("cosine_embedding_loss"), (PRED, TGT, SIGN),
     dict(margin=0.5), (0, 1), "red"),
    ("triplet_margin", F("triplet_margin_loss"), (PRED, TGT, N3[:, :5]), {},
     (0, 1, 2), "red"),
    ("triplet_margin_swap", F("triplet_margin_loss"), (PRED, TGT,
                                                       N3[:, :5]),
     dict(swap=True, p=1.0, reduction="sum"), (0, 1, 2), "red"),
    ("label_smooth", F("label_smooth"), (PROBS,), dict(epsilon=0.2), (0,),
     "ew"),
    ("label_smooth_prior", F("label_smooth"), (PROBS, W5 / W5.sum()), {},
     (0,), "ew"),
    ("sigmoid_focal", F("sigmoid_focal_loss"), (LOGITS, np.round(TGT)), {},
     (0,), "red"),
    ("sigmoid_focal_norm", F("sigmoid_focal_loss"),
     (LOGITS, np.round(TGT), np.array([2.0], f32)), dict(reduction="mean"),
     (0,), "red"),
    ("log_loss", F("log_loss"), (PROBS, np.round(TGT)), {}, (0,), "ew"),
    ("ctc", F("ctc_loss"), CTC_OK, {}, (0,), "red"),
    ("ctc_none", F("ctc_loss"), CTC_OK, dict(reduction="none", blank=0),
     (0,), "red"),
    ("ctc_impossible", F("ctc_loss"), (CTC_LP, CTC_LABELS, CTC_IL, CTC_LL),
     dict(reduction="none"), (), "red"),
    ("dice", F("dice_loss"), (DICE_P, DICE_Y), {}, (0,), "red"),
    ("hsigmoid", F("hsigmoid_loss"), (HS_X, HS_Y, 6, HS_W, HS_B), {},
     (0, 3, 4), "red"),
    ("hsigmoid_custom", lambda m: lambda x, y, w, b, tb, cd:
     m.nn.functional.hsigmoid_loss(x, y, 6, w, b, path_table=tb,
                                   path_code=cd),
     (HS_X, HS_Y, HS_W, HS_B, HS_TABLE, HS_CODE), {}, (0, 2, 3), "red"),
    ("margin_cross_entropy", F("margin_cross_entropy"), (COS, COS_Y), {},
     (0,), "red"),
    ("margin_cross_entropy_softmax", F("margin_cross_entropy"),
     (COS, COS_Y), dict(return_softmax=True, reduction="none",
                        margin2=0.2, margin3=0.1, scale=8.0), (0,), "red"),
    ("softmax_with_cross_entropy", F("softmax_with_cross_entropy"),
     (LOGITS, LABELS[:, None]), {}, (0,), "red"),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_loss_function_matches_the_reference(case):
    name, fn, args, kw, grad, tol = case
    run_both(fn(ref), fn(port), args, kw, grad=grad, tol=tol, what=name)


def test_ctc_impossible_alignment_is_large_and_finite():
    """The reference's CTC takes log(0) as -1e5 (``optax.ctc_loss``): an
    alignment that cannot exist costs ~1e5, not ``inf`` as
    ``F.ctc_loss`` gives."""
    out = port.nn.functional.ctc_loss(
        *[port.to_tensor(a) for a in (CTC_LP, CTC_LABELS, CTC_IL, CTC_LL)],
        reduction="none").numpy()
    assert np.isfinite(out).all() and out[2] > 9e4 and out[:2].max() < 50
    x = port.to_tensor(CTC_LP, stop_gradient=False)
    port.nn.functional.ctc_loss(x, *[port.to_tensor(a) for a in (
        CTC_LABELS, CTC_IL, CTC_LL)]).backward()
    assert np.isfinite(x.grad.numpy()).all()


# (id, layer name, constructor kwargs, forward args, grad inputs)
LAYERS = [
    ("CrossEntropyLoss", {}, (LOGITS, LABELS[:, None]), (0,)),
    ("SoftmaxWithCrossEntropy", {}, (LOGITS, LABELS[:, None]), (0,)),
    ("MSELoss", {}, (PRED, TGT), (0, 1)),
    ("L1Loss", dict(reduction="sum"), (PRED, TGT), (0,)),
    ("NLLLoss", dict(ignore_index=2), (LOGP, LABELS), (0,)),
    ("BCELoss", {}, (PROBS, TGT), (0,)),
    ("BCEWithLogitsLoss", dict(reduction="none"), (LOGITS, TGT), (0,)),
    ("KLDivLoss", dict(reduction="sum"), (LOGP, PROBS), (0,)),
    ("SmoothL1Loss", dict(delta=0.5), (PRED, TGT), (0,)),
    ("HuberLoss", dict(delta=0.5), (PRED, TGT), (0,)),
    ("MarginRankingLoss", dict(margin=0.2), (PRED[:, 1], TGT[:, 1], SIGN),
     (0, 1)),
    ("HingeEmbeddingLoss", dict(margin=0.5), (LOGITS[:, 1], SIGN), (0,)),
    ("CosineEmbeddingLoss", dict(margin=0.1), (PRED, TGT, SIGN), (0, 1)),
    ("TripletMarginLoss", dict(margin=0.5), (PRED, TGT, N3[:, :5]),
     (0, 1, 2)),
    ("CTCLoss", dict(blank=0), CTC_OK, (0,)),
]


@pytest.mark.parametrize("case", LAYERS, ids=[c[0] for c in LAYERS])
def test_loss_layer_matches_the_reference(case):
    name, kw, args, grad = case
    run_both(lambda *a: getattr(ref.nn, name)(**kw)(*a),
             lambda *a: getattr(port.nn, name)(**kw)(*a), args, grad=grad,
             tol="red", what=name)


def test_hsigmoid_layer_matches_the_reference_and_trains():
    """``nn.HSigmoidLoss`` with the reference's weights: its loss and
    gradients, then 20 Adam steps of each (the twin of
    ``tests/test_nn_extras.py``'s training check)."""
    rng = np.random.RandomState(0)
    D, C, N = 8, 6, 32
    X = rng.randn(N, D).astype(f32)
    Y = np.argmax(X @ rng.randn(D, C), axis=1)[:, None].astype(np.int64)
    ref.seed(0)
    rl = ref.nn.HSigmoidLoss(D, C)
    pl = port.nn.HSigmoidLoss(D, C)
    pl.set_state_dict({k: v.numpy() for k, v in rl.state_dict().items()})
    ropt = ref.optimizer.Adam(0.1, parameters=rl.parameters())
    popt = port.optimizer.Adam(0.1, parameters=pl.parameters())
    losses = []
    for _ in range(20):
        r = rl(ref.to_tensor(X), ref.to_tensor(Y))
        p = pl(port.to_tensor(X), port.to_tensor(Y))
        np.testing.assert_allclose(p.numpy(), r.numpy(), **TOL["red"])
        for m, loss, opt in ((ref, r, ropt), (port, p, popt)):
            loss.backward()
            opt.step()
            opt.clear_grad()
        losses.append(float(p.numpy()))
    np.testing.assert_allclose(pl.weight.numpy(), rl.weight.numpy(),
                               rtol=1e-4, atol=1e-4)
    assert losses[-1] < losses[0] * 0.7, losses


@pytest.mark.parametrize("sampler, extra", [
    ("uniform", {}), ("log_uniform", {}),
    ("custom_dist", dict(custom_dist=list(np.linspace(1, 2, 20))))])
def test_nce_with_a_seed_matches_the_reference(sampler, extra):
    """With ``seed`` both draw the negatives from
    ``np.random.RandomState(seed)``: the cost and its gradients match."""
    x = rs.randn(5, 8).astype(f32)
    y = rs.randint(0, 20, (5, 1)).astype(np.int64)
    w = rs.randn(20, 8).astype(f32)
    b = rs.randn(20).astype(f32)
    sw = rs.rand(5).astype(f32)
    kw = dict(num_total_classes=20, num_neg_samples=4, sampler=sampler,
              seed=11, **extra)
    run_both(lambda *a: ref.nn.functional.nce(*a[:3], bias=a[3],
                                              sample_weight=a[4], **kw),
             lambda *a: port.nn.functional.nce(*a[:3], bias=a[3],
                                               sample_weight=a[4], **kw),
             (x, y, w, b, sw), grad=(0, 2, 3), tol="red", what=sampler)


def test_nce_without_a_seed_follows_the_ports_generator():
    x = port.to_tensor(rs.randn(5, 8).astype(f32))
    y = port.to_tensor(rs.randint(0, 20, (5, 1)))
    w = port.to_tensor(rs.randn(20, 8).astype(f32))
    port.seed(3)
    a = port.nn.functional.nce(x, y, w, num_neg_samples=4).numpy()
    port.seed(3)
    b = port.nn.functional.nce(x, y, w, num_neg_samples=4).numpy()
    c = port.nn.functional.nce(x, y, w, num_neg_samples=4).numpy()
    assert a.shape == (5, 1) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(b, c)


# -- the twins of tests/test_optest_loss_creation.py's loss cases ----------
OPTEST = [
    ("mse", lambda m, p, t: m.nn.functional.mse_loss(p, t)),
    ("l1", lambda m, p, t: m.nn.functional.l1_loss(p, t)),
    ("smooth_l1", lambda m, p, t: m.nn.functional.smooth_l1_loss(p, t)),
    ("bce", lambda m, p, t: m.nn.functional.binary_cross_entropy(
        m.nn.functional.sigmoid(p), m.nn.functional.sigmoid(t))),
    ("bce_logits", lambda m, p, t:
     m.nn.functional.binary_cross_entropy_with_logits(
         p, m.nn.functional.sigmoid(t))),
    ("kl_div", lambda m, p, t: m.nn.functional.kl_div(
        m.nn.functional.log_softmax(p), m.nn.functional.softmax(t))),
    ("huber", lambda m, p, t: m.nn.SmoothL1Loss()(p, t)),
]


@pytest.mark.parametrize("name, fn", OPTEST, ids=[c[0] for c in OPTEST])
def test_optest_loss_twin(name, fn):
    """Forward and both gradients against the reference, and the port's
    gradient of the prediction against central differences."""
    run_both(lambda p, t: fn(ref, p, t), lambda p, t: fn(port, p, t),
             (PRED, TGT), grad=(0, 1), tol="red", what=name)
    numeric_grad_check(lambda p: fn(port, p, port.to_tensor(TGT[:2, :3]))
                       .reshape([1]), [PRED[:2, :3]])


def test_optest_cross_entropy_and_nll_twin():
    """``test_cross_entropy_and_nll``'s cases: hard and soft labels, and
    ``nll_loss`` on the log-probabilities giving the same value."""
    run_both(ref.nn.functional.cross_entropy,
             port.nn.functional.cross_entropy, (LOGITS, LABELS), grad=(0,),
             tol="red", what="ce")
    soft = (np.exp(TGT) / np.exp(TGT).sum(-1, keepdims=True)).astype(f32)
    run_both(ref.nn.functional.cross_entropy,
             port.nn.functional.cross_entropy, (LOGITS, soft),
             dict(soft_label=True), grad=(0,), tol="red", what="soft")
    ce = port.nn.functional.cross_entropy(port.to_tensor(LOGITS),
                                          port.to_tensor(LABELS))
    nll = port.nn.functional.nll_loss(port.to_tensor(LOGP),
                                      port.to_tensor(LABELS))
    np.testing.assert_allclose(float(nll), float(ce), rtol=1e-5)


def test_optest_margin_and_embedding_losses_twin():
    ones = np.ones((2, 5), f32)
    for name, args in (("margin_ranking_loss", (PRED[:2], TGT[:2], ones)),
                       ("cosine_embedding_loss", (PRED[:2], TGT[:2],
                                                  SIGN[:2])),
                       ("triplet_margin_loss", (PRED[:2], TGT[:2],
                                                PRED[2:4]))):
        _, out = run_both(F(name)(ref), F(name)(port), args, grad=(0, 1),
                          tol="red", what=name)
        assert float(out) >= 0


# -- the twins of tests/test_nn_extras.py's loss tests ----------------------
def test_dice_loss_ranks_a_good_prediction_first():
    probs = np.array([[[0.9, 0.1], [0.2, 0.8]]], f32)
    good = np.array([[[0], [1]]], np.int64)
    bad = np.array([[[1], [0]]], np.int64)
    for y in (good, bad):
        run_both(F("dice_loss")(ref), F("dice_loss")(port), (probs, y),
                 grad=(0,), tol="red", what="dice")
    loss = [float(port.nn.functional.dice_loss(port.to_tensor(probs),
                                               port.to_tensor(y)))
            for y in (good, bad)]
    assert loss[0] < loss[1]


def test_margin_cross_entropy_softmax_sums_to_one():
    loss, probs = port.nn.functional.margin_cross_entropy(
        port.to_tensor(COS[:, :10]), port.to_tensor(COS_Y),
        return_softmax=True)
    assert float(loss) > 0
    np.testing.assert_allclose(probs.numpy().sum(-1), 1.0, rtol=1e-5)
