"""The inference decoder and the head's branches replayed from CUDA graphs
(``vln_ver_tpu_torch/utils/cuda_graph.py``).

On the CPU: when a call replays and when it stays eager, what the key of
a graph holds, the decoder's counters, the launch bookkeeping of the
hand-written kernel, and the cross-attention's offset normaliser, built
once on the device.  On the card (marked ``gpu``; each skips in the
fixture where there is none): the graphed forward against the same
model's eager forward, bit for bit, on the 3D grid and on
``decoder_on_bev``, in bf16 and fp32; outputs kept across calls; weights
changed in place, swapped ``.data`` and TF32 flags; the training path;
the kernel's launch count.

This file imports neither JAX nor the JAX package, so its card tests run
on a host that has only PyTorch:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \\
        tests/test_torch_decoder_graph.py
"""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_gpu import TINY, _viewpoints
from vln_ver_tpu_torch.models import build_model
from vln_ver_tpu_torch.models.attention import VoxelDeformableAttention3D
from vln_ver_tpu_torch.ops.deform_cuda import KERNEL, DeformAttn2dKernel
from vln_ver_tpu_torch.utils import profiling as tprof
from vln_ver_tpu_torch.utils.cuda_graph import GraphCache, engaged, graph_key

HEADS = ("bev_embed", "all_cls_scores", "all_bbox_preds", "occupancy_preds")


def _inputs(n=2, cfg=TINY, seed=0, device="cpu"):
    return [torch.from_numpy(a).to(device)
            for a in _viewpoints(n, cfg, seed)]


def _graphs(model):
    head = model.pts_bbox_head
    return head.transformer.decoder_graphs, head.branch_graphs


# -- the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("mode", ["inference_mode", "no_grad", "grad"])
def test_cpu_calls_stay_eager(mode):
    """No graph off the card, whatever the autograd mode."""
    x = torch.ones(3)
    ctx = {"inference_mode": torch.inference_mode, "no_grad": torch.no_grad,
           "grad": torch.enable_grad}[mode]
    with ctx():
        assert not engaged([x])


def test_grad_enabled_calls_stay_eager():
    with torch.enable_grad():
        assert not engaged([])


@pytest.mark.parametrize("train", [True, False])
def test_a_module_in_training_mode_has_no_key(train):
    model = build_model(TINY, "cpu")
    head = model.pts_bbox_head
    head.transformer.decoder.layers[1].ffns[0].train(train)
    key = graph_key([torch.ones(2)], [head.transformer.decoder,
                                      head.reg_branches])
    assert (key is None) == train


def _key(model, x, static=(2, 5, 5)):
    head = model.pts_bbox_head
    return graph_key([x], [head.transformer.decoder, head.reg_branches],
                     static)


def _tf32(matmul=None, cudnn=None):
    def change(model, x):
        if matmul is not None:
            torch.backends.cuda.matmul.allow_tf32 = matmul
        if cudnn is not None:
            torch.backends.cudnn.allow_tf32 = cudnn
        return x
    return change


def _swap_data(model, x):
    p = model.pts_bbox_head.transformer.decoder.layers[0].norms[0].weight
    p.data = p.data.clone()
    return x


def _swap_branch_data(model, x):
    p = model.pts_bbox_head.reg_branches[1][0].bias
    p.data = p.data.clone()
    return x


def _copy_in_place(model, x):
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
    return x


def _load_state_dict(model, x):
    sd = {k: v * 2 for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    return x


@pytest.mark.parametrize("change, same", [
    (lambda model, x: x.reshape(4, 3), False),              # shape
    (lambda model, x: x.to(torch.bfloat16), False),         # dtype
    (lambda model, x: x.t().contiguous().t(), False),       # strides
    ("static", False),                                      # grid shape
    ("inference", False),
    (_tf32(matmul=True), False),
    (_tf32(cudnn=False), False),
    (_swap_data, False),
    (_swap_branch_data, False),
    (_copy_in_place, True),
    (_load_state_dict, True),
    (lambda model, x: torch.zeros(3, 4), True),             # new values
], ids=["shape", "dtype", "strides", "static", "inference_mode", "tf32_matmul",
        "tf32_cudnn", "data_swap", "branch_data_swap", "copy_in_place",
        "load_state_dict", "values"])
def test_graph_key_fields(change, same):
    """What recaptures (a new key) and what a replay serves (the same
    key)."""
    model = build_model(TINY, "cpu")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        x = torch.ones(3, 4)
        with torch.no_grad():
            before = _key(model, x)
            if change == "static":
                after = _key(model, x, (1, 5, 5))
            elif change == "inference":
                with torch.inference_mode():
                    after = _key(model, x)
            else:
                after = _key(model, change(model, x))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    assert before is not None and after is not None
    assert (after == before) == same


def test_key_holds_every_parameter_and_buffer():
    model = build_model(TINY, "cpu")
    head = model.pts_bbox_head
    mods = [head.transformer.decoder, head.reg_branches]
    with torch.no_grad():
        key = graph_key([torch.ones(1)], mods)
    want = [t.data_ptr() for m in mods for t in
            list(m.parameters()) + list(m.buffers())]
    assert sorted(key[-1]) == sorted(want) and len(want) > 0


def test_cache_off_the_card_calls_through_and_keeps_nothing():
    cache = GraphCache(kernels=(KERNEL,), name="test_graph")
    calls = []

    def fn(a, b):
        calls.append(1)
        return {"sum": a + b}

    x = torch.ones(2)
    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CPU]):
            outs = [cache(fn, (x, x), []) for _ in range(3)]
    rec = tprof.recorded()
    assert len(calls) == 3 and not cache.graphs
    assert torch.equal(outs[0]["sum"], 2 * x)
    assert rec["counters"] == {"test_graph#calls": 3.0}


@pytest.mark.parametrize("train", [False, True])
def test_model_on_the_cpu_counts_decoder_calls_and_replays_none(train):
    model = build_model(TINY, "cpu").train(train)
    args = _inputs()
    ctx = torch.enable_grad if train else torch.inference_mode
    with ctx(), profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            model(*args)
    rec = tprof.recorded()
    assert rec["counters"]["decoder#calls"] == 2.0
    assert "decoder#graph_replays" not in rec["counters"]
    assert not any(c.graphs for c in _graphs(model))


def test_kernel_launch_bookkeeping():
    """``mark`` / ``restore`` / ``replayed``: a capture counts nothing, a
    replay counts the captured launches and keeps the last one's plan."""
    k = DeformAttn2dKernel()
    k.launches, k.last_plan, k.last_nq = 5, "encoder plan", 192
    before = k.mark()
    k.launches, k.last_plan, k.last_nq = 11, "decoder plan", 100
    after = k.mark()
    k.restore(before)
    assert k.mark() == (5, "encoder plan", 192)
    k.replayed(before, after)
    assert k.mark() == (11, "decoder plan", 100)
    k.last_plan, k.last_nq = "encoder plan", 192
    k.replayed(after, after)                # nothing captured
    assert k.mark() == (11, "encoder plan", 192)


@pytest.mark.parametrize("shapes", [((2, 5, 5),), ((1, 15, 15),),
                                    ((4, 3, 7), (2, 2, 2))])
def test_normalizer_built_once_matches_the_per_call_tensor(shapes):
    attn = VoxelDeformableAttention3D(16, 2, len(shapes), 2)
    with torch.inference_mode():
        got = attn.normalizer(shapes, torch.device("cpu"))
    old = torch.tensor([[w, h, d] for (d, h, w) in shapes],
                       dtype=torch.float32)
    assert got.dtype == torch.float32 and torch.equal(got, old)
    assert not got.is_inference()       # a training forward may save it
    assert attn.normalizer(shapes, torch.device("cpu")) is got
    offsets = torch.randn(2, 3, 2, len(shapes), 2, 3)
    assert torch.equal(offsets / got[None, None, None, :, None, :],
                       offsets / old[None, None, None, :, None, :])


def test_training_forward_after_an_inference_forward():
    """The normaliser cached under inference mode serves a training
    forward and its backward."""
    model = build_model(TINY, "cpu")
    args = _inputs()
    with torch.inference_mode():
        model(*args)
    model.train()
    out = model(*args)
    out["all_bbox_preds"].sum().backward()
    off = model.pts_bbox_head.transformer.decoder.layers[0].attentions[1]
    assert off.sampling_offsets.weight.grad is not None


# -- the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


def _eager(model, args):
    """The same model's forward with autograd on, so with no graph."""
    with torch.enable_grad():
        out = model(*args)
    return {k: v.detach() for k, v in out.items() if torch.is_tensor(v)}


def _cfg(grid, dtype):
    return dataclasses.replace(TINY, dtype=dtype,
                               decoder_on_bev=(grid == "bev"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("grid", ["3d", "bev"])
def test_graphed_forward_is_the_eager_forward_bit_for_bit(cuda, grid,
                                                          dtype):
    cfg = _cfg(grid, dtype)
    model = build_model(cfg, cuda)
    args = _inputs(device=cuda)
    per_forward = cfg.encoder_layers + (cfg.decoder_layers
                                        if grid == "bev" else 0)
    launches = []
    outs = []
    for _ in range(3):      # the capture, then two replays
        before = KERNEL.launches
        with torch.inference_mode():
            outs.append(model(*args))
        launches.append(KERNEL.launches - before)
    replayed_nq = KERNEL.last_nq
    before = KERNEL.launches
    ref = _eager(model, args)
    eager_launches = KERNEL.launches - before
    torch.cuda.synchronize()
    assert eager_launches == per_forward
    assert launches == [per_forward] * 3
    assert replayed_nq == KERNEL.last_nq
    assert [len(c.graphs) for c in _graphs(model)] == [1, 1]
    for out in outs:
        for k in HEADS:
            assert torch.equal(out[k], ref[k]), k


@pytest.mark.gpu
def test_outputs_kept_across_calls_stay_as_they_were(cuda):
    model = build_model(TINY, cuda)
    a, b = _inputs(seed=0, device=cuda), _inputs(seed=1, device=cuda)
    with torch.inference_mode():
        first = model(*a)
        kept = {k: first[k].clone() for k in HEADS}
        second = model(*b)
    torch.cuda.synchronize()
    assert not torch.equal(second["all_cls_scores"], kept["all_cls_scores"])
    for k in HEADS:
        assert torch.equal(first[k], kept[k]), k


@pytest.mark.gpu
def test_replay_reads_weights_changed_in_place(cuda):
    model = build_model(TINY, cuda)
    args = _inputs(device=cuda)
    with torch.inference_mode():
        model(*args)
    head = model.pts_bbox_head
    with torch.no_grad():
        head.transformer.decoder.layers[0].ffns[0].layers[1].weight.mul_(2)
        head.cls_branches[1][-1].bias.add_(1)
        head.reg_branches[0][-1].bias.add_(0.1)
    with torch.inference_mode():
        got = model(*args)
    assert [len(c.graphs) for c in _graphs(model)] == [1, 1]
    ref = _eager(model, args)
    for k in HEADS:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.gpu
def test_data_swap_and_tf32_flags_recapture(cuda):
    cfg = dataclasses.replace(TINY, dtype=torch.bfloat16)
    model = build_model(cfg, cuda)
    args = _inputs(device=cuda)
    dec, br = _graphs(model)
    saved = torch.backends.cuda.matmul.allow_tf32
    p = model.pts_bbox_head.transformer.decoder.layers[1] \
        .attentions[0].attn.in_proj_weight
    try:
        with torch.inference_mode():
            model(*args)
            assert (len(dec.graphs), len(br.graphs)) == (1, 1)
        with torch.no_grad():
            p.data = p.data.clone() * 0.5
        with torch.inference_mode():
            got = model(*args)
            assert (len(dec.graphs), len(br.graphs)) == (2, 1)
            torch.backends.cuda.matmul.allow_tf32 = not saved
            model(*args)
            assert (len(dec.graphs), len(br.graphs)) == (3, 2)
            torch.backends.cuda.matmul.allow_tf32 = saved
        ref = _eager(model, args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    for k in HEADS:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.gpu
def test_training_path_stays_eager(cuda):
    """A train-mode forward with grad (the train step's) and one under
    no_grad capture nothing; the eval forward after them replays."""
    model = build_model(TINY, cuda)
    args = _inputs(device=cuda)
    model.train()
    out = model(*args)
    out["all_bbox_preds"].sum().backward()
    with torch.no_grad():
        model(*args)
    assert not any(c.graphs for c in _graphs(model))
    model.eval()
    with torch.inference_mode():
        model(*args)
    assert [len(c.graphs) for c in _graphs(model)] == [1, 1]
