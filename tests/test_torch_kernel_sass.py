"""CPU tests of the measurement scripts' parsers: ptxas's report and kernel
names (``scripts/kernel_sass.py``) and the training-step profile's
grouping by kernel (``scripts/step_profile.py``). Nothing here compiles or
needs a card."""

import pytest

from blackstar_tpu_torch.scripts import kernel_sass, step_profile

_B1_F32 = ("_ZN40_GLOBAL__N__3db28c86_8_march_cu_9e5307b512march_kernelIfLb1EEEvPKT_S3_S3_"
           "lNS_11MarchParamsIS1_EEPS1_PiS7_S7_S6_")
_B2_F64 = ("_ZN49_GLOBAL__N__bc8ce0f0_16_march_adjoint_cu_ab07be0220march_adjoint_kernelIdEEvPKT_"
           "S3_S3_S3_S3_PKilNS_9AdjParamsIS1_EEPS1_PiS8_")

_REPORT = f"""ptxas info    : 296 bytes gmem
ptxas info    : Compiling entry function '{_B2_F64}' for 'sm_90a'
ptxas info    : Function properties for {_B2_F64}
    40 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 154 registers, used 1 barriers, 40 bytes cumulative stack size
ptxas info    : Compile time = 114.161 ms
ptxas info    : Function properties for __internal_trig_reduction_slowpathd
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '{_B1_F32}' for 'sm_90a'
ptxas info    : Function properties for {_B1_F32}
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 59 registers, used 1 barriers, 32 bytes cumulative stack size, 16 bytes smem
"""


@pytest.mark.parametrize("mangled, name", [
    (_B1_F32, "march_kernel<float, true>"),
    (_B2_F64, "march_adjoint_kernel<double>"),
    ("_Z3foov", "_Z3foov"),
])
def test_short_name(mangled, name):
    assert kernel_sass.short_name(mangled) == name


def test_resources_pairs_each_kernel_with_its_own_lines():
    assert kernel_sass.resources(_REPORT) == {
        "march_adjoint_kernel<double>": "Used 154 registers, 40 bytes stack frame, "
                                        "0 bytes spill stores, 0 bytes spill loads",
        "march_kernel<float, true>": "Used 59 registers, 32 bytes stack frame, "
                                     "0 bytes spill stores, 0 bytes spill loads",
    }


def test_port_kernels_keeps_b1_apart_from_b2():
    by_kernel = {"void march_kernel<float, true>(...)": (3.5, 2),
                 "void march_adjoint_kernel<float>(...)": (9.6, 2),
                 "void star_lookup_kernel<float>(...)": (0.25, 2),
                 "void star_vjp_kernel<float>(...)": (0.3, 2),
                 "void at::native::reduce_kernel<512>(...)": (0.1, 6)}
    got = step_profile.port_kernels(by_kernel)
    assert got == {"B1": {"ms": 3.5, "launches": 2}, "B2": {"ms": 9.6, "launches": 2},
                   "B3": {"ms": 0.25, "launches": 2}, "B4": {"ms": 0.3, "launches": 2}}


_SASS = f"""
	code for sm_90a
		Function : {_B1_F32}
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   MOV R1, c[0x0][0x28] ;                                 /* 0x00000a0000017a02 */
        /*0010*/                   FFMA R2, R3, R3, R4 ;                                  /* 0x0000000303027223 */
        /*0020*/                   MUFU.RSQ R5, R2 ;                                      /* 0x0000000200057308 */
        /*0030*/                   FMUL R6, R5, R5 ;                                      /* 0x0000000505067220 */
        /*0040*/                   MUFU.RCP R7, R6 ;                                      /* 0x0000000600077308 */
        /*0050*/                   FCHK P0, R6, R7 ;                                      /* 0x0000000706007302 */
        /*0060*/               @!P0 CALL.REL.NOINC 0x100 ;                                /* 0x0000000000008944 */
        /*0070*/                   MUFU.RSQ R8, R6 ;                                      /* 0x0000000600087308 */
        /*0080*/               @P1 BRA 0x10 ;                                             /* 0xffffff8000001947 */
        /*0090*/                   EXIT ;                                                 /* 0x000000000000794d */
"""


def test_parse_sass_counts_a_loop_by_kind():
    n_ins, loops = kernel_sass.parse_sass(_SASS)["march_kernel<float, true>"]
    assert n_ins == 10
    assert loops == [kernel_sass.Loop(instructions=8, fp=2, mufu=3,
                                      mufu_ops={"RCP": 1, "RSQ": 2}, fchk=1, calls=1)]
