"""The CUDA lint (``repro_torch.analysis.cuda_lint``): the ptxas report
parser and demangler on a fixture of real ``-Xptxas -v`` lines (sm_90a,
the port's libraries), the spill waiver table and the static shared
memory limit in both directions, the fabricated oversized control, and
the pad-to-tile probes through ``kernels.ops`` on the CPU (the plain
versions). The same rules over the real build log run on the card:
``-k cuda_lint`` of ``tests/test_torch_cuda.py``."""
import pytest
import torch

from repro_torch.analysis import cuda_lint

torch.set_num_threads(1)

# lines of ptxas's report for four of the port's libraries; the first
# entry carries the "Function properties" line ptxas prints before its
# frame line, the others are as a filtered log keeps them
REPORT = {
    "lora_apply": """\
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__a6c1e4ad_13_lora_apply_cu_ccdd2a7a14lora_tc_kernelILb1EEEvPKfS2_NS_7AdapterES2_PfS4_iiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__a6c1e4ad_13_lora_apply_cu_ccdd2a7a14lora_tc_kernelILb1EEEvPKfS2_NS_7AdapterES2_PfS4_iiiii
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__a6c1e4ad_13_lora_apply_cu_ccdd2a7a16lora_gemv_kernelILi2ELb0EEEvPKfS2_NS_7AdapterES2_Pfiiiii' for 'sm_90a'
0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 32768 bytes smem
""",
    "rank_partition_agg": """\
ptxas info    : Compiling entry function '_ZN54_GLOBAL__N__e6299cf4_21_rank_partition_agg_cu_e7acb6f725rank_partition_agg_kernelILb0EEEvPKfS2_S2_PfS3_Pjiiiiii' for 'sm_90a'
16 bytes stack frame, 16 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 16 bytes cumulative stack size, 48 bytes smem
ptxas info    : Compiling entry function '_ZN54_GLOBAL__N__e6299cf4_21_rank_partition_agg_cu_e7acb6f725rank_partition_agg_kernelILb1EEEvPKfS2_S2_PfS3_Pjiiiiii' for 'sm_90a'
16 bytes stack frame, 12 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 16 bytes cumulative stack size, 48 bytes smem
""",
    "ssd_scan": """\
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__70402df9_11_ssd_scan_cu_a485c23a12ssd_scan_outILi8EEEvPKfS2_S2_S2_S2_S2_S2_PfPiiiiiiiiiiiiii' for 'sm_90a'
0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__70402df9_11_ssd_scan_cu_a485c23a14ssd_scan_stateILi4EEEvPKfS2_S2_S2_PK6float2PfS6_Piiiiiiiiii' for 'sm_90a'
0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 101 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__70402df9_11_ssd_scan_cu_a485c23a11ssd_scan_cbEPKfS1_PfP6float2Piiiiiii' for 'sm_90a'
0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 66 registers, used 1 barriers, 16 bytes smem
""",
    "gram": """\
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__f68803cb_7_gram_cu_c3902d5811gram_kernelILb0ELb1EEEvPKfPfS3_Pjiiii' for 'sm_90a'
0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 26128 bytes smem
""",
}


def _records():
    return {r.name: r for r in cuda_lint.collect_build(REPORT)}


def test_parser_reads_every_entry():
    recs = _records()
    assert sorted(recs) == sorted([
        "lora_tc_kernel<true>", "lora_gemv_kernel<2, false>",
        "rank_partition_agg_kernel<false>",
        "rank_partition_agg_kernel<true>", "ssd_scan_out<8>",
        "ssd_scan_state<4>", "ssd_scan_cb", "gram_kernel<false, true>"])
    tc = recs["lora_tc_kernel<true>"]
    assert (tc.library, tc.registers, tc.spill_stores, tc.spill_loads,
            tc.stack_frame, tc.smem) == ("lora_apply", 128, 4, 4, 8, 0)
    assert recs["lora_gemv_kernel<2, false>"].smem == 32768
    out = recs["ssd_scan_out<8>"]
    assert (out.registers, out.spill_stores, out.spill_loads) == (168, 0, 0)
    assert recs["ssd_scan_cb"].smem == 16
    assert recs["gram_kernel<false, true>"].smem == 26128


@pytest.mark.parametrize("mangled,name", [
    ("_ZN13_GLOBAL__N__x3fooILin1ELi4EEEvv", "foo<-1, 4>"),
    ("_Z9plain_fooPf", "plain_foo"),
    ("weighted_stack_b_f32", "weighted_stack_b_f32")])
def test_demangle(mangled, name):
    assert cuda_lint.demangle(mangled) == name


def test_waiver_table_is_what_the_report_spills():
    """The three spilling entries are exactly the waived ones, each at its
    own figures: the report is clean."""
    recs = cuda_lint.collect_build(REPORT)
    spilling = {r.name: (r.spill_stores, r.spill_loads) for r in recs
                if r.spill_stores or r.spill_loads}
    assert spilling == cuda_lint.SPILL_WAIVERS
    progs = cuda_lint.CudaPrograms(recs)
    assert cuda_lint.lint_cuda(progs, "report", {
        "libraries": sorted(REPORT)}) == []


def test_larger_or_new_spill_trips():
    grown = dict(REPORT, rank_partition_agg=REPORT[
        "rank_partition_agg"].replace(
        "12 bytes spill stores, 20 bytes spill loads",
        "16 bytes spill stores, 20 bytes spill loads"))
    fs = cuda_lint.lint_cuda(cuda_lint.CudaPrograms(
        cuda_lint.collect_build(grown)), "grown")
    assert [(f.rule, f.location) for f in fs] == [
        ("cuda-spill-budget",
         "rank_partition_agg:rank_partition_agg_kernel<true>")]
    new = dict(REPORT, gram=REPORT["gram"].replace(
        "0 bytes spill stores, 0 bytes spill loads",
        "0 bytes spill stores, 4 bytes spill loads"))
    fs = cuda_lint.lint_cuda(cuda_lint.CudaPrograms(
        cuda_lint.collect_build(new)), "new")
    assert [f.rule for f in fs] == ["cuda-spill-budget"]


def test_static_smem_limit():
    recs = cuda_lint.collect_build(REPORT)
    progs = cuda_lint.CudaPrograms(recs)
    fs = cuda_lint.lint_cuda(progs, "smem", {"max_static_smem": 32767})
    assert {f.location for f in fs} == {
        "lora_apply:lora_gemv_kernel<2, false>"}
    assert cuda_lint.lint_cuda(progs, "smem") == []


def test_missing_library_report_trips():
    progs = cuda_lint.CudaPrograms(cuda_lint.collect_build(REPORT))
    fs = cuda_lint.lint_cuda(progs, "cov", {
        "libraries": sorted(REPORT) + ["flash_attention"]})
    assert [(f.rule, f.location) for f in fs] == [
        ("cuda-report-coverage", "flash_attention")]


def test_oversized_control_trips_spill_and_smem():
    fs = cuda_lint.lint_cuda(cuda_lint.oversized_control(), "ctl")
    rules = {f.rule for f in fs}
    assert rules == {"cuda-spill-budget", "cuda-static-smem"}
    assert any("lora_tc_kernel<true>" in f.message for f in fs)


def test_pad_probes_pass_on_cpu():
    """Every registry entry at its odd extents (d 300, n 520 for the
    aggregation entries) through ``kernels.ops`` -- the plain versions
    here -- returns its contract shapes, f32 and finite."""
    probes = cuda_lint.probe_registry("cpu")
    assert [p.name for p in probes] == list(cuda_lint.REGISTRY)
    assert all(p.ok for p in probes), [p.detail for p in probes
                                       if not p.ok]
    progs = cuda_lint.CudaPrograms(probes=probes)
    assert cuda_lint.lint_cuda(progs, "probes") == []


def test_failed_probe_trips(monkeypatch):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "rank_partition_agg",
                        lambda *a: torch.zeros(300, 512))
    probes = cuda_lint.probe_registry("cpu", names=["rank_partition_agg"])
    fs = cuda_lint.lint_cuda(cuda_lint.CudaPrograms(probes=probes), "bad")
    assert [f.rule for f in fs] == ["cuda-pad-coverage"]
