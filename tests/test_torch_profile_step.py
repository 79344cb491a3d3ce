"""``diffusionkit_tpu_torch/tools/profile_step.py`` on the CPU: how it files
the card's kernel names (the profiler's demangled and mangled symbols of
the port's kernels, the library's GEMMs, torch's elementwise kernels and
copies) into its categories, and a whole run of the tool at a tiny
configuration with the CPU's activities only, which writes its report."""

import json

import pytest
import torch

from diffusionkit_tpu_torch.tools import profile_step

from test_torch_tools import PROFILER_NAMES

torch.set_num_threads(2)

ATTENTION = ("flash_attention_bshd", "flash_attention", "flash_attention_stats")
ROW = ("mod_ln", "mod_ln_quantize", "quantize", "gelu_quantize")

# Names beyond the port's flash and GEMM kernels: the row kernels, C / #13's
# fp32 tiles, the library's GEMMs and torch's own kernels.
MORE_NAMES = [
    ("void (anonymous namespace)::mod_ln_kernel<__nv_bfloat16>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, int, int, int, float)",
     "mod_ln", "row"),
    ("void (anonymous namespace)::mod_ln_quant_kernel<__nv_bfloat16, 6>((anonymous "
     "namespace)::ModLnQuantParams<__nv_bfloat16>)", "mod_ln_quantize", "row"),
    ("_ZN41_GLOBAL__N__7e71744e_9_mod_ln_cu_86424f8f20gelu_quantize_kernelI13__nv_bfloat16"
     "Li4ELi1EEEvPKT_PaPfii", "gelu_quantize", "row"),
    ("void (anonymous namespace)::tile_absmax_kernel(float const*, float*, int, int, int, int, "
     "int)", "gelu_quant[tiles]", "row"),
    ("_ZN41_GLOBAL__N__7e71744e_9_mod_ln_cu_86424f8f20tile_quantize_kernelEPKfS1_PaPfiiiii",
     "gelu_quant[tiles]", "row"),
    ("void (anonymous namespace)::dequant_mm_3xtf32<4>(float const*, unsigned int const*, "
     "float const*, float const*, float*, int, int, int, int)", "int4_matmul[f32]",
     "int4_matmul[f32]"),
    ("_ZN12_GLOBAL__N_114dequant_mm_f32ILi8EEEvPKfPKvS2_S2_Pfiiii", "int8_matmul[f32]",
     "int8_matmul[f32]"),
    ("nvjet_hsh_256x128_64x4_1x2_h_bz_coopA_NTN", "gemm", "cublas_gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1",
     "gemm", "cublas_gemm"),
    ("Memcpy DtoD (Device -> Device)", "other", "copies"),
    ("Memset (Device)", "other", "copies"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
     "at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}>>",
     "other", "copies"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
     "std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)",
     "other", "elementwise"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::MeanOps<float, float, float, float>, unsigned int, float, 4> >", "other",
     "elementwise"),
    ("cudnn_infer_ampere_scudnn_winograd_128x128_ldg1_ldg4_relu_tile148t_nt_v1", "other",
     "other"),
]


def expected_category(family):
    if family in ATTENTION:
        return "attention"
    if family in ROW:
        return "row"
    return family


@pytest.mark.parametrize("name,family", PROFILER_NAMES)
def test_profile_step_files_the_port_kernels(name, family):
    """Every flash and GEMM instantiation's name: its family (as
    chip_smoke's split files it) and its category (the attention kernels
    under ``attention``, each quantized GEMM family under its own)."""
    assert profile_step.family(name) == family
    assert profile_step.category(name) == expected_category(family)


@pytest.mark.parametrize("name,family,category", MORE_NAMES)
def test_profile_step_files_the_other_kernels(name, family, category):
    assert profile_step.family(name) == family
    assert profile_step.category(name) == category


def test_profile_step_writes_its_report_on_the_cpu(tmp_path):
    """``python -m diffusionkit_tpu_torch.tools.profile_step tiny OUT
    --steps 2 --device cpu``: the CPU's activities only (the plain
    versions' ops), its report written with the keys the card's run
    writes; the categories sum to the total."""
    out = tmp_path / "profile_tiny.json"
    report = profile_step.main(["tiny", str(out), "--steps", "2", "--device", "cpu"])
    saved = json.loads(out.read_text())
    assert saved["mode"] == "tiny" and saved["events"] == "cpu ops" and saved["n_steps"] == 2
    for key in ("wall_ms_per_step", "device_total_ms_per_step", "by_category_ms_per_step",
                "idle_share", "top_kernels"):
        assert key in saved
    cats = saved["by_category_ms_per_step"]
    assert saved["wall_ms_per_step"] > 0 and cats
    assert set(cats) <= {"attention", "row", "cublas_gemm", "elementwise", "copies", "other"}
    assert abs(sum(cats.values()) - saved["device_total_ms_per_step"]) < 1e-6
    assert list(cats.values()) == sorted(cats.values(), reverse=True)
    assert saved["top_kernels"] and all(k["ms_per_step"] >= 0 for k in saved["top_kernels"])
    assert report["by_category_ms_per_step"] == cats


@pytest.mark.skipif(torch.cuda.is_available(), reason="the card is there")
def test_profile_step_needs_the_card_unless_told():
    with pytest.raises(SystemExit):
        profile_step.run("sd3")
