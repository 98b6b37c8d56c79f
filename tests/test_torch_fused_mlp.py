"""The port's fused int8 MLP matvec (kernel K9's plain version and wrapper)
against the JAX probe `experiments/fused_mlp_matvec_probe.py`, on the CPU.

The probe's module constants D and I are set small for the run (D = 256,
I = 512, `block_i` 128); its Pallas kernel runs in interpret mode. The same
seeded numpy weights, in the probe's layout, go through the JAX kernel and,
through `from_probe_arrays`, through the port's plain version.

Tolerances: the JAX kernel and the plain version both sum in f32 and round
h and y to bf16 once, but not in the same order, so a value may round the
other way: max-abs error ≤ 1e-2 of max |y| (a bf16 ulp is at most 0.78 % of
a value) and cosine ≥ 0.9999. The loose references (`xla_mlp` and its port
`dequant_mlp`) round every product to bf16: ≤ 2e-2 of max |y|, cosine ≥
0.999.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from vis_zephyr_tpu_torch.config import tiny_config
from vis_zephyr_tpu_torch.experiments import fused_mlp_matvec_probe as tprobe
from vis_zephyr_tpu_torch.models.mistral import MistralMLP
from vis_zephyr_tpu_torch.ops.quant import quantize_linear

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_D, SMALL_I = 256, 512


@pytest.fixture(scope="module")
def jprobe():
    """The JAX probe module, loaded from its file (`experiments/` is no package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_fused_mlp_matvec_probe", os.path.join(REPO, "experiments", "fused_mlp_matvec_probe.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def small(jprobe, monkeypatch):
    monkeypatch.setattr(jprobe, "D", SMALL_D)
    monkeypatch.setattr(jprobe, "I", SMALL_I)
    return jprobe


def probe_arrays(seed, M):
    """x [M, D] and the probe's weights: codes in [-127, 127], scales that
    vary per column (the probe's own are one constant)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((M, SMALL_D)) * 0.5).astype(np.float32)
    wgu = rng.integers(-127, 128, (SMALL_D, 2 * SMALL_I)).astype(np.int8)
    sgu = (rng.random((1, 2 * SMALL_I)) * 2e-3 + 5e-4).astype(np.float32)
    wd = rng.integers(-127, 128, (SMALL_I, SMALL_D)).astype(np.int8)
    sd = (rng.random((1, SMALL_D)) * 2e-3 + 5e-4).astype(np.float32)
    return x, wgu, sgu, wd, sd


def assert_close(got, want, rel, cosine):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    top = np.abs(want).max()
    assert top > 1e-3
    assert np.abs(got - want).max() <= rel * top, (np.abs(got - want).max(), top)
    cos = (got * want).sum() / np.sqrt((got * got).sum() * (want * want).sum())
    assert cos >= cosine, cos


@pytest.mark.parametrize("M", [1, 3, 8])
def test_plain_version_matches_the_jax_probe_kernel(small, M):
    x, wgu, sgu, wd, sd = probe_arrays(M, M)
    xb = jnp.asarray(x, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = small.fused_mlp_matvec(xb, jnp.asarray(wgu), jnp.asarray(sgu), jnp.asarray(wd),
                                      jnp.asarray(sd), block_i=128)
    weights = tprobe.from_probe_arrays(wgu, sgu, wd, sd)
    got = tprobe.fused_mlp_matvec_plain(torch.from_numpy(x), *weights)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (M, SMALL_D)
    assert_close(got.float().numpy(), want.astype(jnp.float32), 1e-2, 0.9999)
    # The wrapper on a CPU tensor is the plain version, and launches nothing.
    before = tprobe.launches
    assert torch.equal(tprobe.fused_mlp_matvec(torch.from_numpy(x), *weights), got)
    assert tprobe.launches == before


def test_dequant_mlp_matches_the_jax_reference(small):
    x, wgu, sgu, wd, sd = probe_arrays(11, 2)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = small.xla_mlp(xb, jnp.asarray(wgu), jnp.asarray(sgu), jnp.asarray(wd), jnp.asarray(sd))
    weights = tprobe.from_probe_arrays(wgu, sgu, wd, sd)
    got = tprobe.dequant_mlp(torch.from_numpy(x), *weights)
    assert got.dtype == torch.bfloat16
    assert_close(got.float().numpy(), want.astype(jnp.float32), 2e-2, 0.999)
    # And the loose reference sits near the exact one.
    plain = tprobe.fused_mlp_matvec_plain(torch.from_numpy(x), *weights)
    assert_close(got.float().numpy(), plain.float().numpy(), 2e-2, 0.999)


def test_from_probe_arrays_layout():
    _, wgu, sgu, wd, sd = probe_arrays(5, 1)
    gate_q, gate_s, up_q, up_s, down_q, down_s = tprobe.from_probe_arrays(wgu, sgu, wd, sd)
    assert tuple(gate_q.shape) == tuple(up_q.shape) == (SMALL_I, SMALL_D)
    assert tuple(down_q.shape) == (SMALL_D, SMALL_I)
    assert all(t.is_contiguous() for t in (gate_q, up_q, down_q))
    np.testing.assert_array_equal(gate_q[7].numpy(), wgu[:, 7])
    np.testing.assert_array_equal(up_q[7].numpy(), wgu[:, SMALL_I + 7])
    np.testing.assert_array_equal(down_q[:, 9].numpy(), wd[9])
    np.testing.assert_array_equal(up_s.numpy(), sgu[0, SMALL_I:])
    np.testing.assert_array_equal(down_s.numpy(), sd[0])
    assert gate_s.dtype == down_s.dtype == torch.float32


def test_wrapper_refuses_rows_above_the_gate_and_misfit_shapes():
    _, wgu, sgu, wd, sd = probe_arrays(6, 1)
    weights = tprobe.from_probe_arrays(wgu, sgu, wd, sd)
    x = torch.zeros(tprobe.MAX_ROWS + 1, SMALL_D)
    with pytest.raises(ValueError, match="gate"):
        tprobe.fused_mlp_matvec(x, *weights)
    with pytest.raises(ValueError, match="gate"):
        tprobe.fused_mlp_matvec(torch.zeros(SMALL_D), *weights)
    with pytest.raises(ValueError, match="do not fit"):
        tprobe.fused_mlp_matvec(torch.zeros(1, SMALL_D + 8), *weights)
    gate_q, gate_s, up_q, up_s, down_q, down_s = weights
    with pytest.raises(ValueError, match="do not fit"):
        tprobe.fused_mlp_matvec(torch.zeros(1, SMALL_D), gate_q, gate_s, up_q, up_s,
                                down_q.T.contiguous(), down_s)


def test_runs_on_a_load_8bit_mlp_as_it_is():
    """A decoder layer's MLP quantized as `--load-8bit` quantizes it: its
    `QuantLinear` buffers go to the wrapper unchanged, and the fused result
    sits near `mlp(x)` (which rounds g, u and their product to bf16 each)."""
    cfg = tiny_config().decoder
    torch.manual_seed(0)
    mlp = MistralMLP(cfg)
    for name in ("gate_proj", "up_proj", "down_proj"):
        setattr(mlp, name, quantize_linear(getattr(mlp, name)))
    x = torch.randn(2, cfg.hidden_size).to(torch.bfloat16)
    weights = tprobe.quantized_mlp_weights(mlp)
    assert weights[0] is mlp.gate_proj.weight_q and weights[5] is mlp.down_proj.scale
    got = tprobe.fused_mlp_matvec(x, *weights)
    assert_close(got.float().numpy(), mlp(x).float().numpy(), 2e-2, 0.999)


def test_probe_main_runs_its_check_on_the_cpu():
    result = tprobe.main(["--device", "cpu", "--hidden", "256", "--intermediate", "512"])
    assert result["vs_plain"]["rel_err"] == 0.0
    assert result["vs_dequant"]["cosine"] >= 0.999
    assert "us_per_layer" not in result
