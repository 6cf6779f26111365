"""The port's bench report (``mcpx_torch.cli.bench_report``) against the
reference's over the committed ``BENCH_r*.json`` series: the same report,
the same text, the same exit codes."""

import glob
import io
import os

import pytest

from mcpx.cli import bench_report as jreport
from mcpx_torch.cli import bench_report as treport

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERIES = sorted(glob.glob(os.path.join(ROOT, "BENCH_r*.json")))


def test_report_and_text_equal_the_reference():
    assert len(SERIES) >= 2
    runs, jruns = treport.load_runs(SERIES), jreport.load_runs(SERIES)
    assert runs == jruns
    report = treport.build_report(runs)
    assert report == jreport.build_report(jruns)
    assert treport.render_text(report) == jreport.render_text(report)
    assert report["verdict"] in ("ok", "improved", "regressed")


@pytest.mark.parametrize("paths,fmt,fail", [
    (SERIES, "text", False),
    (SERIES, "json", True),
    (SERIES[-3:], "json", False),
    (SERIES[:1], "text", False),
])
def test_run_report_prints_and_exits_as_the_reference(paths, fmt, fail):
    out, jout = io.StringIO(), io.StringIO()
    rc = treport.run_report(paths, fmt=fmt, fail_on_regression=fail, out=out)
    assert rc == jreport.run_report(paths, fmt=fmt, fail_on_regression=fail, out=jout)
    assert out.getvalue() == jout.getvalue()


def test_default_series_is_the_working_directory(monkeypatch):
    monkeypatch.chdir(ROOT)
    assert treport.default_series() == jreport.default_series()
    assert [os.path.basename(p) for p in treport.default_series()] == [os.path.basename(p) for p in SERIES]
