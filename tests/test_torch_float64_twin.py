"""The stage-1 float64 twin of `chip_smoke.py`'s float64 gate, on the CPU at
the smoke preset's stage-1 (16^3 volumes, batch 2).

The spatial and tp phases judge their sharded stage-1 steps against a
float64 step on the card (`_s1_references`). Its twin computes in float64
and takes the codes the one-process float32 step chose
(`_recorded_codes`, `_injected_codes`), because the codebook kernel takes
float32 and bfloat16 only and a near-tie would otherwise be compared as
arithmetic. Checked here: the twin's parameters, buffers and gradients
are float64; its quantizer returns the float32 step's codes; its step lies
within float32 rounding of the float32 step; the gate of the float32 step
against itself passes; and the main path's code search is restored after
the twin's block (on the card it keeps refusing float64, which the
kernel refuses: a `gpu` test).
"""

import pytest
import torch

import chip_smoke as cs
from ldm3d_torch.models import quantizers
from ldm3d_torch.ops import quantize as cbq
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

SPEC = dict(vq_flags=["--preset", "smoke"], vq_size=16, device="cpu")
# The float32 step against the float64 one from the same state, codes and
# volumes: one float32 forward and backward of a tiny network, so float32
# rounding alone; the loss to 1e-6 relative, every gradient within 1e-5 of
# the model's largest.
LOSS_RTOL, MODEL_GRAD_RTOL = 1e-6, 1e-5


@pytest.fixture(scope="module")
def steps():
    """The inputs, the one-process float32 step (its codes recorded) and
    the float64 twin's step with those codes (the codes its quantizer
    returned, and its own float64 search's changed rows)."""
    inp = cs._ddp_s1_inputs(SPEC, 2)
    one = cs._ddp_s1_one_process(SPEC, inp)
    with cs._recorded_codes() as codes:
        m32 = one.train_step(inp["vol"], inp["mask"])
    twin = cs._float64_s1_twin(inp, "cpu")
    returned = []
    twin.model.quantizer.register_forward_hook(
        lambda mod, args, out: returned.append(out[1].indices.reshape(-1)))
    with cs._injected_codes(codes) as changed:
        m64 = twin.train_step(inp["vol"], inp["mask"])
    return dict(inp=inp, one=one, m32=m32, codes=codes, twin=twin, m64=m64,
                returned=returned, changed=changed)


def test_twin_is_float64(steps):
    twin = steps["twin"]
    params = list(twin.model.parameters())
    assert params and all(p.dtype == torch.float64 for p in params)
    assert all(p.grad is not None and p.grad.dtype == torch.float64
               for p in params)
    assert all(b.dtype == torch.float64 for b in twin.model.buffers()
               if b.is_floating_point())
    assert all(s["exp_avg"].dtype == torch.float64
               for s in twin.optimizer.state.values())


def test_twin_takes_the_float32_codes(steps):
    codes, returned = steps["codes"], steps["returned"]
    assert len(codes) == len(returned) == len(steps["changed"]) >= 1
    for c, r in zip(codes, returned):
        assert torch.equal(c.long(), r.long())
    # its own float64 search, counted and not used
    assert all(isinstance(n, int) and 0 <= n <= c.numel()
               for n, c in zip(steps["changed"], codes))


def test_twin_step_within_float32_rounding(steps):
    loss32, loss64 = float(steps["m32"]["loss"]), float(steps["m64"]["loss"])
    assert abs(loss32 - loss64) <= LOSS_RTOL * abs(loss64)
    e = cs._grad_errors(steps["one"].model, steps["twin"].model,
                        cs.SPATIAL_S1_GRAD_RTOL)
    assert e["grads_compared"] == len(list(steps["twin"].model.parameters()))
    assert e["grad_model_rel_err"] <= MODEL_GRAD_RTOL, e["grad_worst5"]


def test_gate_of_the_float32_step_passes(steps):
    """`_s1_references` with the one-process step standing in for the
    sharded one: the gate passes, both distances equal (the same float32
    step), every code kept."""
    one = steps["one"]
    ref = cs._s1_references(SPEC, steps["inp"], one.model,
                            one.model.quantizer.codebooks_used,
                            cs.SPATIAL_S1_GRAD_RTOL)
    gate = ref["gate"]
    assert gate["ok"] and ref["usage_equal_1p"]
    assert all(g["sharded"] == g["one_process"] for g in gate["groups"])
    assert ref["code_rows"] == sum(c.numel() for c in steps["codes"])
    assert 0 <= ref["float64_codes_changed"] <= ref["code_rows"]


def test_main_path_search_restored(steps):
    """The twin's block leaves the quantizers' search as it was, and a
    search it was not given raises."""
    assert quantizers.nearest_codebook_indices is cbq.nearest_codebook_indices
    with pytest.raises(RuntimeError, match="not replayed"):
        with cs._injected_codes(steps["codes"] + steps["codes"][:1]):
            steps["twin"].train_step(steps["inp"]["vol"],
                                     steps["inp"]["mask"])
    assert quantizers.nearest_codebook_indices is cbq.nearest_codebook_indices


@pytest.mark.gpu
def test_codebook_search_refuses_float64_on_the_card():
    """No float64 fallback on the main path: a float64 CUDA tensor is
    refused as the kernel refuses it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    x = torch.randn(256, 8, device="cuda", dtype=torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        cbq.nearest_codebook_indices(x, x[:16])
