"""paddle_tpu_torch's optimizers and regularizers against the JAX reference.

Every optimizer of ``paddle_tpu_torch.optimizer`` takes three eager
steps on the same few named parameters with the same gradients, made
with numpy from a seed, as ``paddle_tpu.optimizer``'s does; the
parameters and every slot (``state_dict``, whose keys must be the
reference's) match at atol 1e-6, rtol 1e-5 in fp32.  A zero bias takes
the trust ratios' branch where a norm is 0.  Under ``multi_precision``
with bf16 parameters the fp32 masters match at the same tolerance, and
on each side every parameter equals its master cast to bf16.

Then ``Model.train_batch`` (captured, ``jit=True``) under
``amp.decorate`` O2 with ``Lamb`` and with ``Momentum``, on the GPT of
``tests/test_torch_train_step.py`` (V 1024, D 128, L 4, H 4) at B 4, T
64, against the reference's jitted ``Model.train_batch`` from the same
weights: three steps, losses at rtol 1e-2 (bf16), the fp32 masters at
atol 5e-4 as in ``test_three_steps_track_the_reference``.  Momentum's
step is linear in the gradient, so every element is held.  Lamb steps
every element by lr·trust·r with r near the sign of its gradient, so an
element whose bf16 gradient lies within rounding of zero moves the way
each side's rounding points.  Three kinds of element are let off, the
first two chosen from the reference's own step-1 gradient, never from
the port's: the key slice of every qkv bias (its exact gradient is 0, softmax
ignores it; the test shows it is ~0), elements of the other masters
whose gradient is below 1/32 of their tensor's RMS gradient (bf16's
2^-8 rounding of each of the B·T = 256 summed terms, grown by the sum,
is of that size), and up to 0.3% of the embedding elements (rarely used
rows).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import regularizer as rreg
from paddle_tpu.core.tensor import Parameter as RefParameter
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import GPT as RefGPT
from paddle_tpu.models import GPTConfig as RefConfig

import paddle_tpu_torch
from paddle_tpu_torch import Model, amp
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch import regularizer as preg
from paddle_tpu_torch.models import GPT, GPTConfig, gpt_state_from_paddle_tpu
from paddle_tpu_torch.models.convert import LINEAR_WEIGHTS
from paddle_tpu_torch.nn import CrossEntropyLoss

SHAPES = {"fc.weight": (6, 4), "fc.bias": (4,), "ln.weight": (5,)}
STEPS = 3
ATOL, RTOL = 1e-6, 1e-5


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    params = {n: rs.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
    params["fc.bias"][:] = 0.0
    grads = [{n: rs.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
             for _ in range(STEPS)]
    return params, grads


# one case per configuration: (optimizer, keywords, per-parameter
# attributes); ``reg`` is the regularizer module of the side being built
CONFIGS = {
    "sgd": ("SGD", lambda reg: dict(learning_rate=0.1), {}),
    "sgd_number_decay": ("SGD", lambda reg: dict(learning_rate=0.1,
                                                 weight_decay=0.05), {}),
    "sgd_l2": ("SGD", lambda reg: dict(learning_rate=0.1,
                                       weight_decay=reg.L2Decay(0.05)), {}),
    "sgd_l1": ("SGD", lambda reg: dict(learning_rate=0.1,
                                       weight_decay=reg.L1Decay(0.05)), {}),
    "sgd_own_regularizer": (
        "SGD", lambda reg: dict(learning_rate=0.1,
                                weight_decay=reg.L2Decay(0.05)),
        {"fc.weight": lambda reg: dict(regularizer=reg.L1Decay(0.2))}),
    "momentum": ("Momentum", lambda reg: dict(learning_rate=0.1,
                                              momentum=0.9), {}),
    "momentum_nesterov_l2": (
        "Momentum", lambda reg: dict(learning_rate=0.1, momentum=0.9,
                                     use_nesterov=True,
                                     weight_decay=reg.L2Decay(0.01)), {}),
    "momentum_l1": ("Momentum", lambda reg: dict(
        learning_rate=0.1, weight_decay=reg.L1Decay(0.01)), {}),
    "momentum_own_lr_and_regularizer": (
        "Momentum", lambda reg: dict(learning_rate=0.1),
        {"ln.weight": lambda reg: dict(
            optimize_attr={"learning_rate": 0.5},
            regularizer=reg.L2Decay(0.3))}),
    "lars": ("LarsMomentum", lambda reg: dict(
        learning_rate=0.1, exclude_from_weight_decay=["ln"]), {}),
    "lars_alias": ("Lars", lambda reg: dict(learning_rate=0.1,
                                            lars_coeff=0.01), {}),
    "adam": ("Adam", lambda reg: dict(learning_rate=0.01,
                                      weight_decay=0.05), {}),
    "adam_lazy_mode": ("Adam", lambda reg: dict(learning_rate=0.01,
                                                lazy_mode=True), {}),
    "adamw_lazy_mode": ("AdamW", lambda reg: dict(learning_rate=0.01,
                                                  weight_decay=0.1,
                                                  lazy_mode=True), {}),
    "adamw_ignores_regularizers": (
        "AdamW", lambda reg: dict(learning_rate=0.01,
                                  weight_decay=reg.L1Decay(0.1)),
        {"fc.weight": lambda reg: dict(regularizer=reg.L2Decay(0.5))}),
    "adamax": ("Adamax", lambda reg: dict(learning_rate=0.01), {}),
    "adamax_l2": ("Adamax", lambda reg: dict(
        learning_rate=0.01, weight_decay=reg.L2Decay(0.1)), {}),
    "adagrad": ("Adagrad", lambda reg: dict(learning_rate=0.1,
                                            initial_accumulator_value=0.1),
                {}),
    "adadelta": ("Adadelta", lambda reg: dict(learning_rate=1.0,
                                              weight_decay=0.01), {}),
    "rmsprop": ("RMSProp", lambda reg: dict(learning_rate=0.01), {}),
    "rmsprop_centered_momentum": ("RMSProp", lambda reg: dict(
        learning_rate=0.01, centered=True, momentum=0.9), {}),
    "lamb": ("Lamb", lambda reg: dict(learning_rate=0.01), {}),
    "lamb_exclude_fn_not_read": ("Lamb", lambda reg: dict(
        learning_rate=0.01, lamb_weight_decay=0.1,
        exclude_from_weight_decay_fn=lambda n: "bias" in n), {}),
    "ftrl": ("Ftrl", lambda reg: dict(learning_rate=0.1, l1=0.01,
                                      l2=0.01), {}),
    "ftrl_lr_power": ("Ftrl", lambda reg: dict(learning_rate=0.1, l1=0.5,
                                               lr_power=-0.3), {}),
    "decayed_adagrad": ("DecayedAdagrad", lambda reg: dict(
        learning_rate=0.01, weight_decay=reg.L1Decay(0.01)), {}),
}


def _ref_side(params, dtype=jnp.float32, attrs=None):
    out = []
    for n, a in params.items():
        p = RefParameter(jnp.asarray(a).astype(dtype), name=n)
        for k, v in ((attrs or {}).get(n, lambda reg: {})(rreg)).items():
            setattr(p, k, v)
        out.append(p)
    return out


def _port_side(params, dtype=torch.float32, attrs=None):
    out = []
    for n, a in params.items():
        p = torch.nn.Parameter(torch.from_numpy(a.copy()).to(dtype))
        for k, v in ((attrs or {}).get(n, lambda reg: {})(preg)).items():
            setattr(p, k, v)
        out.append((n, p))
    return out


def _run(kind, kwargs, attrs, params, grads, dtype=None, master=False):
    """Three steps on each side; returns (reference optimizer, its
    parameters, port optimizer, its named parameters)."""
    rparams = _ref_side(params, dtype or jnp.float32, attrs)
    tparams = _port_side(params, torch.bfloat16 if dtype else torch.float32,
                         attrs)
    ref = getattr(paddle.optimizer, kind)(parameters=rparams,
                                          **kwargs(rreg))
    opt = getattr(popt, kind)(parameters=tparams, **kwargs(preg))
    if master:                       # as amp.decorate sets it on both sides
        ref._multi_precision = opt._multi_precision = True
    for g in grads:
        for p in rparams:
            p.grad = Tensor(jnp.asarray(g[p.name]).astype(p._data.dtype))
        for n, p in tparams:
            p.grad = torch.from_numpy(g[n]).to(p.dtype)
        ref.step()
        opt.step()
    return ref, rparams, opt, tparams


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=ATOL,
                               rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("case", list(CONFIGS))
def test_three_steps_match_the_reference(case):
    kind, kwargs, attrs = CONFIGS[case]
    params, grads = _inputs()
    ref, rparams, opt, tparams = _run(kind, kwargs, attrs, params, grads)
    for rp, (n, p) in zip(rparams, tparams):
        _close(p.detach().numpy(), rp._data, n)
    want = ref.state_dict()
    got = opt.state_dict()
    assert set(got) == set(want)
    assert got["global_step"] == want["global_step"] == STEPS
    for k, v in want.items():
        if k != "global_step":
            _close(got[k].numpy(), v._data, k)


MASTERS = {"momentum": ("Momentum", lambda reg: dict(learning_rate=0.1,
                                                     multi_precision=True)),
           "lars": ("LarsMomentum", lambda reg: dict(learning_rate=0.1,
                                                     multi_precision=True)),
           "adam": ("Adam", lambda reg: dict(learning_rate=0.01,
                                             multi_precision=True)),
           "adamw": ("AdamW", lambda reg: dict(learning_rate=0.01,
                                               multi_precision=True)),
           "lamb": ("Lamb", lambda reg: dict(learning_rate=0.01)),
           "sgd_l1": ("SGD", lambda reg: dict(
               learning_rate=0.1, weight_decay=reg.L1Decay(0.05),
               multi_precision=True))}


@pytest.mark.parametrize("case", list(MASTERS))
def test_bf16_parameters_step_on_fp32_masters(case):
    kind, kwargs = MASTERS[case]
    params, grads = _inputs(1)
    ref, rparams, opt, tparams = _run(kind, kwargs, {}, params, grads,
                                      dtype=jnp.bfloat16, master=True)
    for rp, (n, p) in zip(rparams, tparams):
        want = ref._master_weights[id(rp)]
        got = opt._master_weights[id(p)]
        assert p.dtype == torch.bfloat16 and got.dtype == torch.float32
        _close(got.numpy(), want, n)
        assert torch.equal(p.detach(), got.to(torch.bfloat16)), n
        np.testing.assert_array_equal(
            np.asarray(rp._data.astype(jnp.float32)),
            np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32)))
        # the slots are made from the master: fp32
        for k, v in opt._state[id(p)].items():
            assert v.dtype == torch.float32, k
    # masters are not saved, as in the reference
    assert set(opt.state_dict()) == set(ref.state_dict())
    assert set(opt.bound_tensors()) >= set(opt._master_weights.values())


def test_a_sparse_gradient_raises_naming_a2():
    """Once a raise naming ``ROADMAP.md`` A2; the row-sparse update is
    ported since: a torch module's ``torch.nn.Embedding(sparse=True)``
    gradient under Adam (``lazy_mode`` taken, read nowhere) moves only the
    touched rows, and equals the reference's sparse Adam on the same
    weights and ids."""
    emb = torch.nn.Embedding(10, 4, sparse=True)
    opt = popt.Adam(0.1, parameters=emb.parameters(), lazy_mode=True)
    paddle.seed(0)
    ref_emb = paddle.nn.Embedding(10, 4, sparse=True)
    with torch.no_grad():
        emb.weight.copy_(torch.as_tensor(np.asarray(ref_emb.weight._data)))
    ref_opt = paddle.optimizer.Adam(0.1, parameters=ref_emb.parameters(),
                                    lazy_mode=True)
    before = emb.weight.detach().clone()
    for ids in ([1, 2, 2], [2, 7]):
        emb(torch.tensor(ids)).square().sum().backward()
        assert emb.weight.grad.is_sparse
        opt.step()
        opt.clear_grad()
        out = ref_emb(paddle.to_tensor(np.array(ids)))
        paddle.sum(out * out).backward()
        ref_opt.step()
        ref_opt.clear_grad()
    untouched = [0, 3, 4, 5, 6, 8, 9]
    assert torch.equal(emb.weight.detach()[untouched], before[untouched])
    assert not torch.equal(emb.weight.detach()[[1, 2, 7]],
                           before[[1, 2, 7]])
    _close(emb.weight.detach().numpy(), ref_emb.weight._data, "weight")


def test_minimize_and_the_aliases():
    torch.manual_seed(0)
    nets = [torch.nn.Linear(3, 2) for _ in range(2)]
    nets[1].load_state_dict(nets[0].state_dict())
    x = torch.randn(5, 3)
    a = popt.Momentum(0.1, parameters=nets[0].parameters())
    b = popt.Momentum(0.1, parameters=nets[1].parameters())
    assert a.minimize(nets[0](x).square().mean()) == (None, None)
    nets[1](x).square().mean().backward()
    b.step()
    for p, q in zip(nets[0].parameters(), nets[1].parameters()):
        assert torch.equal(p, q)
    a.clear_gradients()
    assert all(p.grad is None for p in nets[0].parameters())
    b.set_dict(a.state_dict())
    assert torch.equal(b.state_dict()["param_0_velocity"],
                       a.state_dict()["param_0_velocity"])
    with pytest.raises(NotImplementedError, match="ROADMAP.md A7"):
        a.minimize(object())


@pytest.mark.parametrize("weight_decay", [0.5, 1, np.float32(0.5), "0.5"])
def test_weight_decay_takes_what_float_takes(weight_decay):
    rp = [RefParameter(jnp.ones(2), name="w")]
    p = [torch.nn.Parameter(torch.ones(2))]
    ref = paddle.optimizer.SGD(parameters=rp, weight_decay=weight_decay)
    opt = popt.SGD(parameters=p, weight_decay=weight_decay)
    assert opt._weight_decay == ref._weight_decay == float(weight_decay)
    assert type(opt._regularizer_for(p[0])).__name__ == "L2Decay"
    assert repr(opt._regularizer_for(p[0])) == repr(ref._weight_decay_reg)
    assert popt.SGD(parameters=p)._regularizer_for(p[0]) is None
    with pytest.raises(ValueError):
        paddle.optimizer.SGD(parameters=rp, weight_decay="strong")
    with pytest.raises(ValueError):
        popt.SGD(parameters=p, weight_decay="strong")
    assert repr(preg.L1Decay(0.25)) == repr(rreg.L1Decay(0.25))


# -- Model.train_batch under amp.decorate O2 ----------------------------------
WIDTH = dict(vocab_size=1024, hidden_size=128, num_layers=4, num_heads=4,
             max_seq_len=128, ffn_mult=2)     # test_torch_train_step.py
B, T = 4, 64
MODEL_ATOL, LOSS_RTOL = 5e-4, 1e-2
PROBE_LR = 2.0 ** 10             # SGD at this rate exposes the gradient
NOISE_SHARE = 1 / 32             # of a tensor's RMS gradient (docstring)
EMBEDDING_OFF_SHARE = 3e-3       # of the wte and wpe elements


def _as_reference(name, t):
    a = t.detach().float().numpy()
    return a.T if name.endswith(LINEAR_WEIGHTS) else a


def _reference_gradient(ids, labels):
    """The reference's step-1 gradient of every master under decorated
    O2: one jitted SGD step at learning rate 2^10 moves each fp32 master
    by 2^10 times its gradient."""
    paddle.seed(0)
    ref = RefGPT(RefConfig(**WIDTH))
    ropt = paddle.optimizer.SGD(PROBE_LR, parameters=ref.parameters())
    ref, ropt = paddle.amp.decorate(ref, ropt, level="O2")
    before = {n: np.array(a).astype(np.float32) for n, a in
              ref.functional_state()[0].items()}
    rmodel = paddle.Model(ref)
    rmodel.prepare(ropt, paddle.nn.CrossEntropyLoss(), amp_configs="O2")
    rmodel.train_batch([ids], [labels])
    return {n: (before[n] - np.array(a)) / PROBE_LR
            for n, a in ropt._fn_state["master"].items()}


@pytest.fixture(scope="module")
def decorated_runs():
    rs = np.random.RandomState(0)
    ids = rs.randint(0, WIDTH["vocab_size"], (B, T)).astype(np.int32)
    labels = np.roll(ids, -1, 1).reshape(B, T, 1).astype(np.int64)
    out = {"ref_grad": _reference_gradient(ids, labels)}
    for kind, kwargs in (("Lamb", dict(learning_rate=1e-3,
                                       lamb_weight_decay=0.01)),
                         ("Momentum", dict(learning_rate=0.1,
                                           momentum=0.9))):
        paddle.seed(0)
        ref = RefGPT(RefConfig(**WIDTH))
        state = {n: np.array(a) for n, a in
                 ref.functional_state()[0].items()}
        net = GPT(GPTConfig(**WIDTH), device="cpu")
        net.load_state_dict(gpt_state_from_paddle_tpu(state, device="cpu"),
                            strict=True)
        ropt = getattr(paddle.optimizer, kind)(parameters=ref.parameters(),
                                               **kwargs)
        ref, ropt = paddle.amp.decorate(ref, ropt, level="O2")
        opt = getattr(popt, kind)(parameters=net.parameters(), **kwargs)
        net, opt = amp.decorate(net, opt, level="O2")
        rmodel = paddle.Model(ref)
        rmodel.prepare(ropt, paddle.nn.CrossEntropyLoss(), amp_configs="O2")
        model = Model(net).prepare(opt, CrossEntropyLoss(), amp_configs="O2")
        run = {"ref_loss": [], "loss": [], "tied": []}
        for _ in range(3):
            run["ref_loss"].append(float(rmodel.train_batch(
                [ids], [labels])["loss"]))
            run["loss"].append(float(model.train_batch([ids],
                                                       [labels])["loss"]))
            run["tied"].append(all(
                torch.equal(p.detach(),
                            opt._master_weights[id(p)].to(p.dtype))
                for p in net.parameters()))
        run.update(
            ref_master={n: np.array(a) for n, a in
                        ropt._fn_state["master"].items()},
            ref_params={n: np.array(a) for n, a in
                        ref.functional_state()[0].items()},
            master={n: _as_reference(n, opt._master_weights[id(p)])
                    for n, p in net.named_parameters()},
            param_dtypes={n: p.dtype for n, p in net.named_parameters()},
            captured=len(model._steps.entries()))
        out[kind] = run
    return out


def _let_off(name, grad):
    """The elements of one master that Lamb may move apart from the
    reference (module docstring), from the reference's gradient."""
    if name.startswith(("wte", "wpe")):
        return np.zeros(grad.shape, bool)
    free = np.zeros(grad.shape, bool)
    if name.endswith("qkv.bias"):
        D = grad.size // 3
        free[D:2 * D] = True                    # q, k, v: the key slice
    rms = np.sqrt(np.mean(grad[~free] ** 2))
    return free | (np.abs(grad) < NOISE_SHARE * rms)


def test_the_key_bias_gradient_is_zero(decorated_runs):
    grads = decorated_runs["ref_grad"]
    biases = [n for n in grads if n.endswith("qkv.bias")]
    assert len(biases) == WIDTH["num_layers"]
    for name in biases:
        q, k, v = np.split(np.abs(grads[name]), 3)
        assert k.max() <= 2.0 ** -8 * max(q.max(), v.max()), name


@pytest.mark.parametrize("kind", ["Lamb", "Momentum"])
def test_decorated_o2_train_batch_tracks_the_reference(decorated_runs,
                                                       kind):
    r = decorated_runs[kind]
    assert r["captured"] == 1
    np.testing.assert_allclose(r["loss"], r["ref_loss"], rtol=LOSS_RTOL)
    assert r["loss"][-1] < r["loss"][0]
    assert set(r["master"]) == set(r["ref_master"]) == set(r["ref_params"])
    embedding_off = embedding_total = 0
    for name, want in r["ref_master"].items():
        assert want.dtype == np.float32
        off = np.abs(r["master"][name] - want) > MODEL_ATOL
        if kind == "Lamb" and name.startswith(("wte", "wpe")):
            embedding_off += int(off.sum())
            embedding_total += want.size
            continue
        if kind == "Lamb":
            off &= ~_let_off(name, decorated_runs["ref_grad"][name])
        assert not off.any(), (name, np.argwhere(off)[:8].tolist())
    if kind == "Lamb":
        assert embedding_off <= EMBEDDING_OFF_SHARE * embedding_total, (
            embedding_off, embedding_total)


@pytest.mark.parametrize("kind", ["Lamb", "Momentum"])
def test_decorated_parameters_stay_their_masters_in_bf16(decorated_runs,
                                                         kind):
    r = decorated_runs[kind]
    assert r["tied"] == [True] * 3
    assert all(a.dtype == np.float32 for a in r["master"].values())
    for name, a in r["ref_params"].items():
        np.testing.assert_array_equal(
            a.astype(np.float32),
            np.asarray(jnp.asarray(r["ref_master"][name]).astype(
                jnp.bfloat16)).astype(np.float32), err_msg=name)
        assert r["param_dtypes"][name] == torch.bfloat16, name
