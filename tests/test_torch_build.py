"""The C entry points of the port's CUDA sources against the ctypes
signatures the loader gives them (`flexam_tpu_torch/ops/build.py`
`SIGNATURES`), on the CPU.

ctypes trusts `argtypes`: a parameter added to a kernel's C entry point and
not to SIGNATURES (or a pointer declared as an int) would pass the wrong
bits, and only the card would show it. This test reads every `extern "C"`
block of `csrc/*.cu` and holds each function's name, parameter count and
parameter types to SIGNATURES, both ways round.
"""

import ctypes
import re

import pytest

from flexam_tpu_torch.ops import build

_ENTRY = re.compile(r"\bint\s+(flexam_\w+)\s*\(([^)]*)\)\s*\{")


def _extern_c_blocks(text: str) -> list:
    """The bodies of the `extern "C" { ... }` blocks of a source."""
    blocks, pos = [], 0
    while True:
        start = text.find('extern "C" {', pos)
        if start < 0:
            return blocks
        i = start + len('extern "C" {')
        depth = 1
        while depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        blocks.append(text[start:i])
        pos = i


def _ctype(param: str):
    """The ctypes type a C parameter declaration is passed as."""
    param = param.strip()
    if "*" in param:
        return ctypes.c_void_p
    kind = param.split()[0]
    return {"int": ctypes.c_int, "float": ctypes.c_float}[kind]


def _entry_points() -> dict:
    """{name: [ctypes type of each parameter]} over every csrc/*.cu."""
    found = {}
    for path in sorted(build.CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", path.read_text())
        for block in _extern_c_blocks(text):
            for name, params in _ENTRY.findall(block):
                params = params.strip()
                assert name not in found, f"{name} defined twice"
                found[name] = ([] if params in ("", "void") else
                               [_ctype(p) for p in params.split(",")])
    return found


def test_every_entry_point_has_a_signature():
    found = _entry_points()
    assert found, "no extern \"C\" entry points found in csrc/*.cu"
    assert sorted(found) == sorted(build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_signature_matches_source(name):
    params = _entry_points()[name]
    declared = build.SIGNATURES[name]
    assert len(params) == len(declared), (
        f"{name}: {len(params)} parameters in the source, "
        f"{len(declared)} in SIGNATURES")
    assert params == declared, f"{name}: parameter types differ"


def test_parser_sees_a_drift():
    """The parser counts what the source says: a source with one parameter
    more than SIGNATURES is caught."""
    src = ('extern "C" {\nint flexam_flash_attention(const void* q, '
           'const void* k, const void* v, void* o, const void* k_len, '
           'void* workspace, int tail_items, int parts, '
           'int B, int H, int Lq, int Lk, int D, float s, int extra, '
           'void* stream) {\n  return 0;\n}\n}  // extern "C"\n')
    (name, params), = _ENTRY.findall(_extern_c_blocks(src)[0])
    got = [_ctype(p) for p in params.split(",")]
    assert got != build.SIGNATURES[name]
    assert len(got) == len(build.SIGNATURES[name]) + 1


@pytest.mark.parametrize("params,expected", [
    ("const void* kidx, const void* nnz, void* counter, int B", True),
    ("const void* kidx, const void* nnz, int B", False),
    ("const void* kidx, const void* counters, int B", False),
])
def test_attention_ab_finds_the_counter_by_name(tmp_path, params, expected):
    """`tools/attention_ab.py` passes B5 a counter word only where the
    tree's C entry point names a `counter` parameter."""
    from flexam_tpu_torch.tools import attention_ab
    csrc = tmp_path / "flexam_tpu_torch" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "sparse_attention.cu").write_text(
        f'extern "C" {{\nint flexam_sparse_attention(const void* q, '
        f'{params}, void* stream) {{\n  return 0;\n}}\n}}\n')
    assert attention_ab.takes_counter(tmp_path) is expected


def test_attention_ab_reads_this_tree_s_counter():
    from pathlib import Path
    from flexam_tpu_torch.tools import attention_ab
    assert attention_ab.takes_counter(Path(build.CSRC).parents[1])


@pytest.mark.parametrize("symbol,label", [
    ("_ZN12_GLOBAL__N_113ln_mod_kernelILi12EEEvPK13__nv_bfloat16PKfS5_S5_"
     "PS1_iiiiiiif", "ln_mod_kernel<12>"),
    ("_ZN12_GLOBAL__N_119rmsnorm_rope_kernelILi20EEEvPK13__nv_bfloat16S3_"
     "PKfS5_PS1_iiiif", "rmsnorm_rope_kernel<20>"),
    ("_ZN12_GLOBAL__N_113ln_mod_kernelEPK13__nv_bfloat16PKfS5_S5_PS1_iiif",
     "ln_mod_kernel"),
    ("_ZN12_GLOBAL__N_112flash_kernelE14CUtensorMap_stS0_S0_6Params",
     "flash_kernel"),
    ("_ZN12_GLOBAL__N_112flash_kernelINS_8Bf16PlanILi256EEEEEv14CUtensorMap"
     "_stS3_S3_NS_6ParamsE", "flash_kernel<256>"),
    ("_ZN12_GLOBAL__N_112flash_kernelIN6flexam6hopper8D256PlanILi80EEEEEv14C"
     "UtensorMap_stS5_S5_NS_6ParamsE", "flash_kernel<256>"),
    ("_ZN12_GLOBAL__N_116single_kv_kernelIN6flexam6hopper8D256PlanILi64ELb1E"
     "EEEv14CUtensorMap_stS5_S5_S5_NS_6ParamsE", "single_kv_kernel<256>"),
    ("_ZN12_GLOBAL__N_116single_kv_kernelINS_7F32PlanEEEv14CUtensorMap_stS2_"
     "S2_NS_6ParamsE", "single_kv_kernel<f32>"),
    ("_ZN12_GLOBAL__N_116single_kv_kernelIN6flexam6hopper9SplitPlanILi128ELi1"
     "28ELi2ELb1EEEEEv14CUtensorMap_stS5_S5_S5_NS_6ParamsE",
     "single_kv_kernel<128>"),
    ("_ZN12_GLOBAL__N_116single_kv_kernelIN6flexam6hopper9SplitPlanILi128ELi6"
     "4ELi3ELb1EEEEEv14CUtensorMap_stS5_S5_S5_NS_6ParamsE",
     "single_kv_kernel<128>"),
    ("_ZN12_GLOBAL__N_112flash_kernelIN6flexam6hopper9SplitPlanILi128ELi128ELi"
     "2ELb1EEENS_13B1Measures128EEEv14CUtensorMap_stS6_S6_S6_NS_6ParamsE",
     "flash_kernel<128>"),
    ("_ZN12_GLOBAL__N_112flash_kernelIN6flexam6hopper8Bf16PlanILi128EEENS_13B1"
     "Measures128EEEv14CUtensorMap_stS6_S6_S6_NS_6ParamsE", "flash_kernel<128>"),
    ("_ZN12_GLOBAL__N_112flash_kernelIN6flexam6hopper7F32PlanENS_10NoMeasuresE"
     "EEv14CUtensorMap_stS5_S5_S5_NS_6ParamsE", "flash_kernel<f32>"),
    ("_ZN12_GLOBAL__N_112flash_kernelIN6flexam6hopper9SplitPlanILi256ELi80ELi"
     "2ELb0EEEEEv14CUtensorMap_stS5_S5_S5_NS_6ParamsE", "flash_kernel<256>"),
    ("_ZN12_GLOBAL__N_116single_kv_kernelIN6flexam6hopper9SplitPlanILi256ELi6"
     "4ELi2ELb1EEEEEv14CUtensorMap_stS5_S5_S5_NS_6ParamsE",
     "single_kv_kernel<256>"),
    ("_ZN12_GLOBAL__N_116single_kv_kernelIN6flexam6hopper12F32SplitPlanEEEv1"
     "4CUtensorMap_stS4_S4_S4_NS_6ParamsE", "single_kv_kernel<f32>"),
    ("_ZN12_GLOBAL__N_117flash_wide_kernelILb1EEEv14CUtensorMap_stS1_S1_N6"
     "flexam6hopper4wide6ParamsE", "flash_wide_kernel<f32>"),
    ("_ZN12_GLOBAL__N_117flash_wide_kernelILb0EEEv14CUtensorMap_stS1_S1_N6"
     "flexam6hopper4wide6ParamsE", "flash_wide_kernel"),
    ("_ZN12_GLOBAL__N_117ln_mod_f32_kernelILi3EEEvPKfS2_S2_S2_Pfiiiiiif",
     "ln_mod_f32_kernel<3>"),
    ("_ZN52_GLOBAL__N__ae624383_19_sparse_attention_cu_48146cd823sparse_atte"
     "ntion_kernelIN6flexam6hopper7F32PlanEEEv14CUtensorMap_stS4_S4_NS_6Para"
     "msE", "sparse_attention_kernel<f32>"),
    ("_ZN52_GLOBAL__N__ae624383_19_sparse_attention_cu_48146cd823sparse_atte"
     "ntion_kernelIN6flexam6hopper8Bf16PlanILi128EEEEEv14CUtensorMap_stS5_S5"
     "_NS_6ParamsE", "sparse_attention_kernel<128>"),
    ("_ZN50_GLOBAL__N__5bdf8bfa_17_int8_attention_cu_780a02df21int8_attentio"
     "n_kernelINS_11Int8F32PlanEEEv14CUtensorMap_stS2_S2_NS_6ParamsE",
     "int8_attention_kernel<f32>"),
    ("_ZN50_GLOBAL__N__5bdf8bfa_17_int8_attention_cu_780a02df21int8_attentio"
     "n_kernelINS_12Int8Bf16PlanILi256EEEEEv14CUtensorMap_stS3_S3_NS_6Params"
     "E", "int8_attention_kernel<256>"),
    ("_ZN50_GLOBAL__N__5bdf8bfa_17_int8_attention_cu_780a02df26int8_attentio"
     "n_wide_kernelILb1EEEv14CUtensorMap_stS1_S1_N6flexam6hopper4wide6Params"
     "E", "int8_attention_wide_kernel<f32>"),
    ("_Z10other_kernelPf", None),
])
def test_attention_ab_labels_kernels(symbol, label):
    """Mangled symbols map to their kernel, a template with its row-vector
    count (the row kernels are instantiated for several widths), the head
    dim of its bf16 plan (`SplitPlan`'s first argument; B1 with its
    measures after the plan), or "f32" for an fp32 instance
    (`F32SplitPlan` too)."""
    from flexam_tpu_torch.tools import attention_ab
    assert attention_ab.kernel_label(symbol) == label


def test_attention_ab_clock_medians_over_legs():
    """The clocks line: the medians of the samples inside a tree's legs,
    and none outside them."""
    from flexam_tpu_torch.tools import attention_ab
    sampler = object.__new__(attention_ab.ClockSampler)
    sampler.samples = [(1.0, 1500.0, 690.0), (1.5, 1400.0, 700.0),
                       (2.0, 1980.0, 100.0), (3.2, 1600.0, 695.0)]
    got = sampler.over([(0.9, 1.6), (3.0, 3.5)])
    assert got == {"samples": 3, "sm_mhz_median": 1500.0,
                   "sm_mhz_min": 1400.0, "power_w_median": 695.0}
    assert sampler.over([(5.0, 6.0)]) == {"samples": 0}


def test_attention_ab_reports_the_flagship_instantiation():
    from flexam_tpu_torch.tools import attention_ab
    by_label = {"ln_mod_kernel<4>": 1, "ln_mod_kernel<12>": 2,
                "flash_kernel": 3}
    assert attention_ab.flagship(by_label, "ln_mod_kernel") == 2
    assert attention_ab.flagship(by_label, "flash_kernel") == 3
    assert attention_ab.flagship({"ln_mod_kernel": 5}, "ln_mod_kernel") == 5
    assert attention_ab.flagship(by_label, "rmsnorm_rope_kernel") is None


def test_attention_ab_counts_wide_accesses():
    from flexam_tpu_torch.tools import attention_ab
    ops = {"LDG.E.128": 12, "LDG.E.128.CONSTANT": 2, "LDG.E": 5,
           "STG.E.128": 12, "STG.E.64": 1, "LDS.128": 3}
    assert attention_ab.wide_accesses(ops) == {"LDG.E.128": 14,
                                               "STG.E.128": 12}


@pytest.mark.parametrize("params,names", [
    ("const void* x, const void* shift, const void* scale, const void* mask, "
     "void* out, int rows, int S, int D, float eps, void* stream",
     ["x", "shift", "scale", "mask", "out", "rows", "S", "D", "eps",
      "stream"]),
    ("const void* x, const void* shift, const void* scale,\n"
     "                         const void* mask, void* out, int B, int S, "
     "int D, int sh_b,\n int sh_r, int sc_b, int sc_r, float eps, "
     "void* stream",
     ["x", "shift", "scale", "mask", "out", "B", "S", "D", "sh_b", "sh_r",
      "sc_b", "sc_r", "eps", "stream"]),
])
def test_attention_ab_reads_parameter_names(tmp_path, params, names):
    """A tree's B3/B4 arguments are passed by the names of its C
    declaration, so a parent whose entry point takes `rows` and this tree's,
    which takes `B` and the terms' strides, are both bound right."""
    from flexam_tpu_torch.tools import attention_ab
    csrc = tmp_path / "flexam_tpu_torch" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "ln_modulation.cu").write_text(
        f'extern "C" {{\nint flexam_ln_modulation({params}) {{\n'
        f'  return 0;\n}}\n}}\n')
    assert attention_ab.c_params(tmp_path, "ln_modulation.cu",
                                 "flexam_ln_modulation") == names
    assert attention_ab.c_params(tmp_path, "ln_modulation.cu",
                                 "flexam_rmsnorm_rope") == []

    called = []

    class Lib:
        def flexam_ln_modulation(self, *args):
            called.append(args)
            return 0
    values = {n: f"<{n}>" for n in names + ["rows", "B", "sh_b"]}
    values["tensors"] = ()
    attention_ab.row_launcher(Lib(), tmp_path, "flexam_ln_modulation",
                              "ln_modulation.cu", values)()
    assert called == [tuple(f"<{n}>" for n in names)]


def test_attention_ab_binds_this_tree_s_row_kernels():
    """This tree's B3/B4 declarations name exactly the parameters
    SIGNATURES gives types for."""
    from pathlib import Path
    from flexam_tpu_torch.tools import attention_ab
    root = Path(build.CSRC).parents[1]
    for source, entry in (("ln_modulation.cu", "flexam_ln_modulation"),
                          ("rmsnorm_rope.cu", "flexam_rmsnorm_rope")):
        names = attention_ab.c_params(root, source, entry)
        assert len(names) == len(build.SIGNATURES[entry])
        assert names[0] == "x" and names[-1] == "stream"
