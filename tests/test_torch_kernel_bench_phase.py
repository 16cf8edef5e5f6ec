"""``chip_smoke.py``'s kernel_bench phase rehearsed on the CPU at a small size
(moved out of ``test_torch_kernel_bench.py`` so that another worker runs
it), with two torch threads: no kernel is launched on the CPU."""
import chip_smoke as cs
from test_torch_kernel_bench import CPU, SMALL
from test_torch_train_phase import two_torch_threads  # noqa: F401  (autouse: 2 threads)


def test_kernel_bench_phase_counts_no_launch_on_the_cpu():
    kb = cs.kernel_bench(CPU, duration_s=0.01, fused_shape=(1, 8, 16, 3), lane_cases=SMALL[:1],
                         grid=1)
    assert kb["launches"] == {"fused_stack": 0, "fused_stack_packed": 0, "lane_packing_mm": 0,
                              "palette_dither": 0}
    assert [r["name"] for r in kb["fused"]] == ["eager bf16", "cuda fused", "cuda packed-2"]
    assert [r["variant"] for r in kb["lane"]] == ["baseline"]
