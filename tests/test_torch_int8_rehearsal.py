"""``scripts/bench_int8_qat.py`` and ``chip_smoke.py``'s int8 phase rehearsed
at a small size on the CPU (moved out of ``test_torch_int8.py`` so that
another worker runs it), with two torch threads."""
import torch

from test_torch_train_phase import two_torch_threads  # noqa: F401  (autouse: 2 threads)


def test_study_and_chip_smoke_int8_rehearsal():
    """scripts/bench_int8_qat.py and chip_smoke.py's int8 phase at a small
    size on the CPU: every number present and finite, the CPU's
    accumulators equal to themselves through the same route."""
    import chip_smoke as cs

    rec = cs.int8_phase(torch.device("cpu"), qat_steps=3, duration_s=0.02,
                        frame_hw=(64, 96), crop=32)
    cs.check_int8(rec, torch.device("cpu"))
    assert [r["k"] for r in rec["accumulators"]] == [27, 1728, 2304]
    assert max(r["max_abs_acc"] for r in rec["accumulators"]) > 0
    study = rec["study"]
    assert study["frame_hw"] == [64, 96] and len(study["frames"]) == 8
    c3 = study["conv3_heavy"]
    assert len(c3["ptq_psnr_vs_fp32"]) == len(c3["qat_psnr_vs_fp32"]) == 8
    assert set(c3["ms_per_frame"]) == {"bf16", "int8_qat"}
    b = c3["conv2_breakdown"]
    assert (b["k"], b["n"]) == (1728, 256) and all(v > 0 for v in b.values())
    assert set(study["pix_shuffle"]["ms_per_frame"]) == {"k1", "eager_bf16", "int8_ptq"}
