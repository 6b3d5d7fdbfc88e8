"""The trace reduction of scripts/trace_batch.py, checked on CPU inputs:
HLO op-name attribution through fusions, scope naming, busy-time union."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import trace_batch as tb  # noqa: E402

HLO = """\
HloModule jit__batch_first_pass, entry_computation_layout={...}

%fused_computation.1 (param_0: f32[4]) -> f32[4] {
  %param_0 = f32[4]{0} parameter(0)
  ROOT %add.1 = f32[4]{0} add(%param_0, %param_0), metadata={op_type="add" op_name="jit(f)/while/body/admm_zprox/add"}
}

%fused_computation.2 (param_0: f32[4]) -> f32[4] {
  %param_0 = f32[4]{0} parameter(0)
  %mul.2 = f32[4]{0} multiply(%param_0, %param_0), metadata={op_name="jit(f)/while/body/admm_prox_dual/mul"}
  ROOT %sub.2 = f32[4]{0} subtract(%mul.2, %param_0), metadata={op_name="jit(f)/while/body/admm_zprox/sub"}
}

ENTRY %main.3 (p: f32[4]) -> f32[4] {
  %p = f32[4]{0} parameter(0)
  %loop_add_fusion = f32[4]{0} fusion(%p), kind=kLoop, calls=%fused_computation.1, metadata={op_name="jit(f)/while/body/add"}
  %input_mixed_fusion = f32[4]{0} fusion(%p), kind=kInput, calls=%fused_computation.2
  %custom-call.7 = f32[4]{0} custom-call(%p), custom_call_target="__cublas$gemm", metadata={op_name="jit(f)/while/body/admm_x_update/dot_general"}
  ROOT %copy.9 = f32[4]{0} copy(%p)
}
"""


def test_parse_hlo_follows_fusions():
    ops = tb.parse_hlo(HLO)
    assert tb.scope_of(ops["loop_add_fusion"]) == "admm_zprox"
    assert tb.scope_of(ops["input_mixed_fusion"]) == "mixed"
    assert tb.scope_of(ops["custom-call.7"]) == "admm_x_update"
    assert tb.scope_of(ops["copy.9"]) == "other"


def test_hlo_op_names_reads_module_files(tmp_path):
    name = "module_0047.jit__batch_first_pass.sm_9.0_gpu_after_optimizations.txt"
    (tmp_path / name).write_text(HLO)
    (tmp_path / "module_0047.jit__batch_first_pass.before_optimizations.txt"
     ).write_text("ignored")
    names = tb.hlo_op_names(str(tmp_path))
    assert list(names) == ["jit__batch_first_pass"]
    got = tb._op_names(names, "jit__batch_first_pass(42)", "custom-call.7")
    assert tb.scope_of(got) == "admm_x_update"
    assert tb._op_names(names, "jit_other", "custom-call.7") == set()


@pytest.mark.parametrize("spans, busy", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (5, 15), (20, 30)], 25),
    ([(20, 30), (0, 40)], 40),
    ([(0, 5), (5, 9)], 9),
])
def test_busy_is_the_union_of_intervals(spans, busy):
    assert tb._busy_ns(spans) == busy
