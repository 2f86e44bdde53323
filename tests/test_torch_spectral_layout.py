"""The launch layouts of the spectral kernels: the logdet cascade kernel's
(`ops/logdet.launch_config`, K6) and the sum-of-k-largest kernel's block
sizing (`ops/sumlargest.launch_config`, K7), for cones of order 1 to 600;
and the plain version's work count behind K6's bound in chip_smoke.py
(`logdet_plain_work`). No card needed."""

import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

from scs_tpu_torch.ops import logdet, sumlargest  # noqa: E402

NS = range(1, 601)


def _logdet_layout_ok(n: int) -> None:
    lay = logdet.launch_config(n)
    m = n + 3
    G = lay.lanes
    assert G & (G - 1) == 0 and (G >= m or G == 32)
    assert G == 32 or G // 2 < m
    assert lay.groups * G == 32 * lay.warps
    assert lay.threads == 32 * lay.warps * lay.cones_per_block <= 128
    assert lay.cones_per_block == 1 or lay.warps == 1
    if lay.entries:
        assert lay.storage == "registers" and lay.shared_bytes == 0
        assert (lay.entries - 1) * G < m <= lay.entries * G
    else:
        assert lay.storage == "shared" and m > 64
        assert lay.shared_bytes + logdet.SHARED_STATIC <= 232448
        assert lay.shared_bytes % (8 * 32 * lay.warps) == 0
    # a cone that fits a warp takes a warp (four cones a block); beyond,
    # a block of warps, the line searches split between them
    assert (lay.warps == 1) == (m <= 32)
    assert lay.ipm_warps == (4 if lay.entries else lay.warps)
    assert logdet.launch_config(n) == lay


def test_logdet_layout():
    """For each n: lanes a group a power of two, at least n + 3 or 32; the
    groups times the lanes fill the warps of a cone; registers where a
    lane holds at most two entries, shared memory within 227 KB (the
    kernel's static exchange included) otherwise; one layout for each n."""
    for n in NS:
        try:
            _logdet_layout_ok(n)
        except AssertionError as e:
            raise AssertionError(f"n = {n}: {logdet.launch_config(n)}") from e


def test_logdet_layouts_partition_the_orders():
    """Every order maps to exactly one layout; the lanes and the storage
    change only where m = n + 3 crosses a power of two or leaves the
    registers, and the warps of a shared-memory cone only fall with n."""
    lays = [logdet.launch_config(n) for n in NS]
    kinds = [(lay.entries, lay.lanes, lay.storage) for lay in lays]
    edges = [n for n, a, b in zip(NS[1:], kinds, kinds[1:]) if a != b]
    assert edges == [2, 6, 14, 30, 62]
    assert [lay.storage for lay in lays].count("shared") == 600 - 61
    shared = [lay.warps for lay in lays if lay.storage == "shared"]
    assert shared == sorted(shared, reverse=True)
    assert shared[0] == 4 and shared[-1] == 2


def test_logdet_layout_beyond_shared_memory():
    """A cone whose four warps' copies outgrow 227 KB takes fewer warps,
    and one whose single copy does takes the global scratch."""
    warp_bytes = {n: 23 * -(-(n + 3) // 32) * 256 for n in (400, 1400)}
    lay = logdet.launch_config(400)
    assert lay.storage == "shared"
    assert lay.warps == (232448 - 2048) // warp_bytes[400] < 4
    lay = logdet.launch_config(1400)
    assert lay.storage == "global" and lay.shared_bytes == 0
    assert lay.warps == 4


def _sum_largest_layout_ok(n: int) -> None:
    lay = sumlargest.launch_config(n)
    assert lay.threads % 32 == 0
    assert lay.cones_per_block <= lay.threads < lay.cones_per_block + 32
    assert sumlargest.launch_config(n) == lay
    if n < sumlargest.STAGE_MIN_N:
        assert lay == (128, 128, 0, 0)
        return
    assert lay.stride % 2 == 1 and n <= lay.stride <= n + 1
    assert lay.shared_bytes == 8 * lay.stride * lay.cones_per_block
    assert lay.shared_bytes <= 232448
    assert 1 <= lay.cones_per_block <= 128
    assert (lay.cones_per_block == 128
            or 8 * lay.stride * (lay.cones_per_block + 1) > 232448)


def test_sum_largest_layout():
    """For each n: rows read in place (no shared memory) below
    STAGE_MIN_N; from there cones a block 128 while their rows fit, fewer
    up to 227 KB, at an odd row stride of n or n + 1 doubles; threads
    whole warps, one a cone."""
    assert sumlargest.STAGE_MIN_N == 14
    for n in NS:
        try:
            _sum_largest_layout_ok(n)
        except AssertionError as e:
            raise AssertionError(
                f"n = {n}: {sumlargest.launch_config(n)}") from e


def test_sum_largest_layout_beyond_shared_memory():
    """Rows longer than 227 KB are read in place: no shared memory."""
    lay = sumlargest.launch_config(40000)
    assert lay.stride == 0 and lay.shared_bytes == 0
    assert lay.cones_per_block == lay.threads == 128


def test_logdet_plain_work_counts_the_plain_run():
    """chip_smoke.logdet_plain_work, on 16 cones of order 6 of which the
    first runs the IPM: the plain version's bits unchanged; a Newton step
    in every iteration but a converging one, 1 to 61 trial points a step;
    IPM steps no more than 100 a variant run, 2 to 62 merit evaluations a
    step (the affine search's and the nonmonotone search's first)."""
    import chip_smoke
    from scs_tpu_torch.cones import spectral
    args = chip_smoke._logdet_ipm_blocks(6, 16, 11)
    ref, work = chip_smoke.logdet_plain_work(args)
    plain = spectral.logdet_cone_plain(*(a.clone() for a in args))
    assert all(torch.equal(a, b) for a, b in zip(ref, plain))
    its = int((plain[3] % 1000).sum())
    assert its - 16 <= work["newton_its"] <= its
    assert (work["newton_its"] <= work["newton_trials"]
            <= 61 * work["newton_its"])
    assert 1 <= work["newton_trials_max"] <= 61
    assert int(plain[3][0]) >= 1000
    assert 1 <= work["ipm_its"] <= 100 * int((plain[3] // 1000).sum())
    assert 2 * work["ipm_its"] <= work["ipm_merits"] <= 62 * work["ipm_its"]
