"""The host-side helpers of kubedtn_tpu_torch/kernel_bench.py on the CPU:
the SASS loop counter that chip_smoke.py's operation counts come from,
the line fit of K3's T(S), and the instrumented copy of csrc/shaping.cu
that `--timeline` builds (its anchors must still be in the kernel)."""

import pytest

from kubedtn_tpu_torch import _build
from kubedtn_tpu_torch import kernel_bench as kb

# the shape of `cuobjdump -sass` lines: address, predicate, instruction
SASS = """
        Function : _Z4loopPfi
        /*0000*/                   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;   /* 0x0 */
        /*0010*/                   ISETP.GE.AND P0, PT, R2, 0x1, PT ;        /* 0x0 */
        /*0020*/              @!P0 BRA 0x80 ;                                /* 0x0 */
        /*0030*/                   FADD R3, R3, 1 ;                          /* 0x0 */
        /*0040*/                   FMUL R3, R3, R3 ;                         /* 0x0 */
        /*0050*/                   VIADD R2, R2, 0xffffffff ;                /* 0x0 */
        /*0060*/                   ISETP.NE.AND P0, PT, R2, RZ, PT ;         /* 0x0 */
        /*0070*/               @P0 BRA 0x30 ;                                /* 0x0 */
        /*0080*/                   EXIT ;                                    /* 0x0 */
"""


def test_loops_counts_the_body_of_each_backward_branch():
    instrs = kb.parse_sass(SASS)["_Z4loopPfi"]
    assert len(instrs) == 9
    assert instrs[2] == (0x20, "@!P0 BRA 0x80")
    [loop] = kb.loops(instrs)  # the forward branch at 0x20 is no loop
    assert (loop["target"], loop["branch"]) == ("0x30", "0x70")
    assert loop["instructions"] == 5
    assert loop["opcodes"] == {"FADD": 1, "FMUL": 1, "VIADD": 1,
                               "ISETP.NE.AND": 1, "BRA": 1}


@pytest.mark.parametrize("text,want", [
    ("@P0 BRA 0x30", "BRA"), ("@!UP1 FADD R3, R3, 1", "FADD"),
    ("IMAD.WIDE.U32 R4, R2, R5, RZ", "IMAD.WIDE.U32"), ("", "")])
def test_opcode_drops_the_predicate(text, want):
    assert kb.opcode(text) == want


def test_fit_line_recovers_a_and_b():
    a, b = kb.fit_line([1, 2, 5, 10], [17.4 + 2.1 * s for s in (1, 2, 5, 10)])
    assert a == pytest.approx(17.4)
    assert b == pytest.approx(2.1)


def test_instrumented_source_stamps_the_fused_kernel():
    src = (_build.CSRC / "shaping.cu").read_text()
    out = kb.instrumented_source(src)
    assert out.count("kdt_now(") == 5  # the helper, then 4 call sites
    assert "kdt_copy_stamps" in out and "%%smid" in out
    # everything before the fused kernel is untouched
    k = src.index("template <class Uniforms>\n__global__")
    assert out.startswith(src[:k])


def test_instrumented_source_refuses_a_changed_kernel():
    src = (_build.CSRC / "shaping.cu").read_text()
    with pytest.raises(RuntimeError, match="anchors"):
        kb.instrumented_source(src.replace("  count[e] = st.cnt;\n}",
                                           "  count[e] = st.cnt + 0;\n}"))
