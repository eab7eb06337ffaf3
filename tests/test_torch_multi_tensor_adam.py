"""The optimizer's fused step (``ops.kernels.multi_tensor_adam``) on the
CPU: its plan, its plain version and its routing.

The CUDA kernel runs on the card only (``chip_smoke.py`` phase ``opt``
holds it against this plain version there, and bit for bit against the
plain version on the CPU); here:

- the launch plan: every tensor cut into ``CHUNK``-element chunks in
  launch groups of at most ``MAX_TENSORS`` tensors, and the kernels'
  walk over it (``plan_cover``, modelled thread by thread as the kernel
  walks: 16-byte body and scalar tail, or all scalar for a misaligned
  tensor) visits every element of every tensor exactly once, ragged
  tails, empty and one-element tensors and many groups included;
- ``kernels_per_step``: one update a group, plus a sum of squares a
  group and one scale block with the clip;
- the plain version: the per-leaf ``Adam._update_leaf`` bit for bit,
  f32 / bf16 / bf16 with a master / f16 tensors in one call, with and
  without the global-norm clip (then ``ClipGradByGlobalNorm.clip_values``
  first, each clipped gradient rounded to its type), returning [scale,
  norm]; with a given scale it uses that scale;
- routing: ``Adam.step`` / ``AdamW.step`` make one call a step with
  every live parameter, the global-norm clip passed as ``clip_norm`` and
  any other clip applied before; on CPU tensors the call is the plain
  version and launches nothing;
- the kernel's contract, checked before any pointer leaves Python:
  f64 parameters, gradients of another type, moments that are not
  contiguous f32, mismatched shapes and non-contiguous parameters raise.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.ops.kernels import multi_tensor_adam as mta

SIZES = [0, 1, 3, 7, 8, 9, 1000, mta.CHUNK - 1, mta.CHUNK, mta.CHUNK + 1,
         3 * mta.CHUNK + 17]


def _cover_ok(numels, aligned, **kw):
    p = mta.plan(numels, **kw)
    for t0, nt, c0, nc in p.groups:
        assert nt <= kw.get("max_tensors", mta.MAX_TENSORS)
        assert ((p.chunks[c0:c0 + nc, 0] >= 0)
                & (p.chunks[c0:c0 + nc, 0] < nt)).all()
    cover = mta.plan_cover(p, numels, aligned, chunk=kw.get("chunk",
                                                             mta.CHUNK))
    return all((c == 1).all() for c in cover), p


@pytest.mark.parametrize("aligned", [True, False])
def test_the_walk_covers_every_element_once(aligned):
    ok, p = _cover_ok(SIZES, [aligned] * len(SIZES))
    assert ok
    assert len(p.groups) == 1
    assert len(p.chunks) == sum(-(-n // mta.CHUNK) for n in SIZES)


def test_many_groups_and_mixed_alignment_are_covered():
    rng = np.random.default_rng(0)
    numels = [int(n) for n in rng.integers(0, 300, 23)]
    aligned = [bool(a) for a in rng.integers(0, 2, 23)]
    ok, p = _cover_ok(numels, aligned, chunk=64, max_tensors=4)
    assert ok and len(p.groups) == 6
    assert [g[1] for g in p.groups] == [4, 4, 4, 4, 4, 3]
    firsts = [g[2] for g in p.groups]
    assert firsts == sorted(firsts) and firsts[0] == 0


def test_a_planted_fault_in_the_walk_shows():
    p = mta.plan([100], chunk=64)
    bad = mta.Plan(p.groups, p.chunks[:1])          # the tail chunk lost
    cover = mta.plan_cover(bad, [100], [True], chunk=64)
    assert not (cover[0] == 1).all()


def test_kernels_per_step():
    assert mta.kernels_per_step(219, False) == 1
    assert mta.kernels_per_step(219, True) == 3
    assert mta.kernels_per_step(mta.MAX_TENSORS + 1, True) == 5


def _tensors(seed, kinds):
    """(grads, params, m, v, masters, wds) for tensors of ``kinds``:
    'f32', 'bf16', 'bf16m' (with an f32 master), 'f16', 'f32m' (a 0-size
    master sentinel)."""
    rng = np.random.default_rng(seed)
    out = [[] for _ in range(6)]
    for i, kind in enumerate(kinds):
        n = [5, 130, 1, 64, 77][i % 5]
        dt = {"f32": torch.float32, "f32m": torch.float32,
              "bf16": torch.bfloat16, "bf16m": torch.bfloat16,
              "f16": torch.float16}[kind]
        p = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dt)
        g = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dt)
        mp = (p.float().clone() if kind == "bf16m" else
              torch.zeros(0) if kind == "f32m" else None)
        for lst, t in zip(out, (g, p, torch.zeros(n), torch.zeros(n), mp,
                                0.0 if i % 3 == 0 else 0.02)):
            lst.append(t)
    return out


def _clone(ts):
    g, p, m, v, mp, wd = ts
    return [g, [t.clone() for t in p], [t.clone() for t in m],
            [t.clone() for t in v],
            [None if t is None else t.clone() for t in mp], wd]


@pytest.mark.parametrize("decoupled", [False, True])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_the_plain_version_is_the_per_leaf_update(clip, decoupled):
    kinds = ["f32", "bf16", "bf16m", "f16", "f32m", "bf16", "f32"]
    a = _tensors(1, kinds)
    b = _clone(a)
    for step in (1, 2, 3):
        info = mta.multi_tensor_adam(*a, lr=0.01, beta1=0.9, beta2=0.999,
                                     epsilon=1e-8, step=step,
                                     decoupled=decoupled, clip_norm=clip)
        g, p, m, v, mp, wd = b
        if clip is not None:
            g = tnn.ClipGradByGlobalNorm(clip).clip_values(g)
            scale, gn = info.tolist()
            assert scale < 1 and abs(scale * gn - clip) < 1e-6
        else:
            assert info is None
        bc1, bc2 = (mta.bias_correction(x, step) for x in (0.9, 0.999))
        for i in range(len(kinds)):
            new_p, new_m, new_v = mta.adam_leaf(
                g[i], p[i], m[i], v[i], mp[i], 0.01, 0.9, 0.999, 1e-8, bc1,
                bc2, wd[i], decoupled)
            m[i], v[i] = new_m, new_v
            if mp[i] is not None and mp[i].numel():
                mp[i] = new_p.clone()
            p[i] = new_p.to(p[i].dtype)
    for x, y in zip(a[1:5], b[1:5]):
        for s, t in zip(x, y):
            assert (s is None) == (t is None)
            if s is not None:
                assert s.dtype == t.dtype and torch.equal(s, t)
    scale = torch.tensor(0.25)
    c = _tensors(2, ["bf16", "f32"])
    d = _clone(c)
    info = mta._ref_multi_tensor_adam(*c, 0.01, 0.9, 0.999, 1e-8, 1, True,
                                      clip_scale=scale)
    assert info[0] == scale
    d[0] = [(g.float() * scale).to(g.dtype) for g in d[0]]
    mta._ref_multi_tensor_adam(*d, 0.01, 0.9, 0.999, 1e-8, 1, True)
    assert all(torch.equal(s, t) for s, t in zip(c[1], d[1]))


@pytest.mark.parametrize("clip", [None, "global", "value"])
def test_adam_steps_through_one_call(monkeypatch, clip):
    calls = []
    real = mta.multi_tensor_adam

    def spy(grads, params, *a, **kw):
        calls.append((len(params), kw["clip_norm"], [g.clone()
                                                    for g in grads]))
        return real(grads, params, *a, **kw)

    monkeypatch.setattr(topt.optimizer, "multi_tensor_adam", spy)
    ps = [torch.nn.Parameter(torch.randn(n)) for n in (4, 9, 2)]
    frozen = torch.nn.Parameter(torch.randn(3), requires_grad=False)
    c = {"global": tnn.ClipGradByGlobalNorm(0.1),
         "value": tnn.ClipGradByValue(0.05), None: None}[clip]
    opt = topt.AdamW(parameters=ps + [frozen], grad_clip=c,
                     multi_precision=True)
    before = mta.multi_tensor_adam.launches
    for _ in range(2):
        for p in ps[:2]:
            p.grad = torch.ones_like(p)
        opt.step()
    assert len(calls) == 2 and all(n == 2 for n, _, _ in calls)
    assert all(cn == (0.1 if clip == "global" else None)
               for _, cn, _ in calls)
    if clip == "value":
        assert all((g == 0.05).all() for _, _, gs in calls for g in gs)
    assert mta.multi_tensor_adam.launches == before      # the CPU: no kernel
    assert (opt._clip_info is not None) == (clip == "global")
    assert torch.equal(ps[2], ps[2].detach())


def test_the_kernel_contract_is_checked_before_launch():
    g, p, m, v, mp, wd = _tensors(3, ["f32", "bf16"])

    def check(**over):
        args = dict(grads=g, params=p, exp_avgs=m, exp_avg_sqs=v,
                    masters=mp, weight_decays=wd)
        args.update(over)
        mta._check(**args)

    check()
    with pytest.raises(TypeError, match="f32, bf16 or f16"):
        check(params=[p[0].double(), p[1]], grads=[g[0].double(), g[1]])
    with pytest.raises(TypeError, match="f32, bf16 or f16"):
        check(grads=[g[0], g[1].float()])
    with pytest.raises(TypeError, match="contiguous f32"):
        check(exp_avgs=[m[0], m[1].bfloat16()])
    with pytest.raises(ValueError, match="shapes differ"):
        check(exp_avg_sqs=[v[0], v[1][:-1]])
    with pytest.raises(ValueError, match="contiguous"):
        big = torch.zeros(10, 2)
        check(params=[big[:, 0], p[1]], grads=[torch.zeros(10), g[1]],
              exp_avgs=[torch.zeros(10), m[1]],
              exp_avg_sqs=[torch.zeros(10), v[1]])
    with pytest.raises(ValueError, match="one length"):
        check(weight_decays=wd[:1])
