"""On the GPU: the fused pass-1/pass-2 scan and device edit distance against
the host oracle at real read widths. Marked `chip`; skips without a GPU.

    JAX_PLATFORMS=cuda python -m pytest -m chip tests/
"""

import sys

import pytest

import chip_smoke


@pytest.mark.chip
def test_scan_matches_oracle_on_gpu(gpu, tmp_path, monkeypatch):
    # 151 bp 'real'-profile pairs (merged rows up to 200 bp) on a 2 Mbp
    # panel; 30% junction pairs overflow the 1024-survivor cap
    monkeypatch.setattr(sys, "argv", ["chip-test"])
    w = chip_smoke.prepare(
        str(tmp_path / "data"), panel_mbp=2.0, n_full=65536, n_sub=8192,
        sub_junction=0.3, n_planted=2,
    )
    chip_smoke.phase_full(w, str(tmp_path))
    chip_smoke.phase_parity(w, str(tmp_path))


@pytest.mark.chip
def test_edit_distance_matches_host_on_gpu(gpu):
    chip_smoke.phase_edit_distance(n=4096)
