"""The trace reduction (llicti_tpu/utils/profile.py): stage attribution
through the optimized HLO's op metadata, busy time as the union of
kernel intervals, idle share, and which events count."""
import jax
import jax.numpy as jnp
import numpy as np
from jax.profiler import ProfileData

from llicti_tpu.utils.profile import hlo_stages, profile_dispatch, reduce_trace

HLO = '''
HloModule jit_image_fn

%fused_computation.7 (param_0: f32[4]) -> f32[4] {
  %param_0 = f32[4]{0} parameter(0)
  %erf.1 = f32[4]{0} erf(%param_0), metadata={op_name="jit(image_fn)/cdf_table/erf"}
  ROOT %dynamic-update-slice.2 = f32[4]{0} dynamic-update-slice(%erf.1), metadata={op_name="jit(image_fn)/dynamic_update_slice"}
}

%fused_computation.8 (param_0.1: s32[4]) -> s32[4] {
  %param_0.1 = s32[4]{0} parameter(0)
  %le.1 = pred[4]{0} compare(%param_0.1), metadata={op_name="jit(image_fn)/rans_decode/cond/while/body/le"}
  ROOT %sel.1 = s32[4]{0} select(%le.1), metadata={op_name="jit(image_fn)/cdf_table/max"}
}

ENTRY %main.9 (x: f32[4]) -> f32[4] {
  %x = f32[4]{0} parameter(0), metadata={op_name="x"}
  %custom-call.3 = f32[4]{0} custom-call(%x), custom_call_target="__cudnn$convForward", metadata={op_name="jit(image_fn)/interp_conv/conv_general_dilated"}
  %input_reduce_fusion.8 = s32[4]{0} fusion(%x), kind=kInput, calls=%fused_computation.8
  %copy.4 = f32[4]{0} copy(%x), metadata={op_name="jit(image_fn)/transpose"}
  ROOT %loop_dynamic_update_slice_fusion.7 = f32[4]{0} fusion(%custom-call.3), kind=kLoop, calls=%fused_computation.7, metadata={op_name="jit(image_fn)/dynamic_update_slice"}
}
'''

TRACE = '''
planes {
  id: 1
  name: "/device:GPU:0"
  lines {
    id: 1
    name: "Stream #13(Kernel)"
    timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 2000000 }
    events { metadata_id: 2 offset_ps: 1000000 duration_ps: 2000000
             stats { metadata_id: 1 str_value: "custom-call.3" } }
    events { metadata_id: 3 offset_ps: 5000000 duration_ps: 1000000 }
    events { metadata_id: 4 offset_ps: 6000000 duration_ps: 500000
             stats { metadata_id: 1 str_value: "while.12" } }
    events { metadata_id: 5 offset_ps: 6500000 duration_ps: 500000 }
  }
  lines {
    id: 2
    name: "XLA Modules"
    timestamp_ns: 1000
    events { metadata_id: 6 offset_ps: 0 duration_ps: 9000000 }
  }
  lines {
    id: 3
    name: "XLA Ops"
    timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 2000000 }
  }
  event_metadata { key: 1 value { id: 1
                   name: "loop_dynamic_update_slice_fusion_7" } }
  event_metadata { key: 2 value { id: 2 name: "sm90_xmma_fprop_cudnn" } }
  event_metadata { key: 3 value { id: 3 name: "MemcpyD2D" } }
  event_metadata { key: 4 value { id: 4 name: "input_reduce_fusion_8" } }
  event_metadata { key: 5 value { id: 5 name: "copy_4" } }
  event_metadata { key: 6 value { id: 6 name: "jit_image_fn" } }
  stat_metadata { key: 1 value { id: 1 name: "hlo_op" } }
}
planes {
  id: 2
  name: "/host:CPU"
  lines {
    id: 1
    name: "python"
    events { metadata_id: 1 offset_ps: 0 duration_ps: 50000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "interp_conv" } }
}
'''


def test_hlo_stages_reads_fused_metadata():
    st = hlo_stages(HLO)
    # the fusion's own op_name (its root) names no stage; its body does
    assert st["loop_dynamic_update_slice_fusion_7"] == (
        "cdf_table", "jit(image_fn)/dynamic_update_slice")
    assert st["custom_call_3"][0] == "interp_conv"
    assert st["input_reduce_fusion_8"][0] == "cdf_table+rans_decode"
    assert st["copy_4"][0] == "other"


def test_reduce_trace_stages_busy_and_idle(tmp_path):
    d = tmp_path / "plugins" / "profile" / "run"
    d.mkdir(parents=True)
    (d / "host.xplane.pb").write_bytes(
        ProfileData.text_proto_to_serialized_xspace(TRACE))
    r = reduce_trace(str(tmp_path), HLO)
    ms = r["stage_ms"]
    want = {"cdf_table": 0.002, "interp_conv": 0.002, "unattributed": 0.001,
            "cdf_table+rans_decode": 0.0005, "other": 0.0005}
    assert set(ms) == set(want)
    np.testing.assert_allclose([ms[k] for k in want], list(want.values()))
    # union of [1000, 4000] and [6000, 8000] ns over the window 1000-8000
    np.testing.assert_allclose(r["busy_ms"], 0.005)
    np.testing.assert_allclose(r["window_ms"], 0.007)
    np.testing.assert_allclose(r["idle_share"], 2 / 7)
    assert r["top_ops"][0] == [
        "cdf_table", "loop_dynamic_update_slice_fusion_7", 0.002,
        "jit(image_fn)/dynamic_update_slice"]
    # without the HLO nothing is attributed
    assert set(reduce_trace(str(tmp_path))["stage_ms"]) == {"unattributed"}


def test_profile_dispatch_attributes_scopes_on_cpu(tmp_path):
    """End to end on the CPU client: named scopes of a real program come
    back as stages through its compiled HLO text."""
    @jax.jit
    def f(x):
        with jax.named_scope("interp_conv"):
            y = x @ x
        with jax.named_scope("cdf_table"):
            return jax.lax.cummax(jnp.round(jax.scipy.special.erf(y)),
                                  axis=1)

    x = jnp.asarray(np.random.default_rng(0).uniform(
        -1, 1, (128, 128)).astype(np.float32))
    hlo = f.lower(x).compile().as_text()
    jax.block_until_ready(f(x))
    r = profile_dispatch(lambda: f(x), str(tmp_path), hlo)
    r2 = reduce_trace(str(tmp_path), hlo, plane_prefix="/host:CPU")
    assert r2["stage_ms"].get("interp_conv", 0) > 0
    assert any("cdf_table" in k for k in r2["stage_ms"])
    # the default (GPU) planes are absent on the CPU
    assert r["stage_ms"] == {} and r["idle_share"] is None
