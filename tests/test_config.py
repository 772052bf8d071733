"""Config parser behavior parity (vs run_hicAssembler.py:9-245 semantics)."""

import sys

import pytest

from hic_genome_assembler_tpu import config


def write_cfg(tmp_path, text):
    p = tmp_path / "cfg.txt"
    p.write_text(text)
    return str(p)


def test_defaults_present():
    var = config.default_variables()
    assert var["hyperGeom"] is True
    assert var["hmm"] is False
    assert var["minSize"] == 5
    assert var["modularity"] == 0.05
    assert var["psig"] == 0.05
    assert var["nScaffolds"] == 6
    assert var["scanScaffolds"] == 5
    assert var["lengthCutoff"] == 500000
    assert var["lookAhead"] == 0.2
    assert var["resolution"] == ""


def test_parse_basic(tmp_path):
    cfg = write_cfg(
        tmp_path,
        "\n".join(
            [
                "### comment line",
                "",
                "resolution = 100000",
                "saveFilesDirectory = /tmp/files",
                "savePlotsDirectory = /tmp/plots",
                "binGroupFile = bins.txt",
                "avgClusterPlot = plot.png",
                "hmm = True",
                "hyperGeom = False",
                "minSize = 7",
                "lookAhead = False",
            ]
        ),
    )
    var = config.read_config_file_to_variables(cfg)
    assert var["resolution"] == 100000
    # Path prefixing happens at parse time with the right directory.
    assert var["binGroupFile"] == "/tmp/files/bins.txt"
    assert var["avgClusterPlot"] == "/tmp/plots/plot.png"
    assert var["hmm"] is True and var["hyperGeom"] is False
    assert var["minSize"] == 7
    assert var["lookAhead"] is False


def test_bad_numeric_keeps_default(tmp_path, capsys):
    cfg = write_cfg(tmp_path, "minSize = notanint\nmodularity = 1.5\n")
    var = config.read_config_file_to_variables(cfg)
    assert var["minSize"] == 5
    assert var["modularity"] == 0.05  # >1 clamps back to default
    out = capsys.readouterr().out
    assert "WARNING" in out


def test_bad_resolution_exits(tmp_path):
    cfg = write_cfg(tmp_path, "resolution = abc\n")
    with pytest.raises(SystemExit):
        config.read_config_file_to_variables(cfg)


def test_ensure_all_set_flags_empty_and_mutex():
    var = config.default_variables()
    assert config.ensure_all_variables_are_set(var) is True  # many keys empty
    for key, val in var.items():
        if val == "":
            var[key] = "x" if key != "resolution" else 1
    assert config.ensure_all_variables_are_set(var) is False
    var["hmm"] = True  # both strategies set -> fatal
    assert config.ensure_all_variables_are_set(var) is True


def _all_set(**overrides):
    var = config.default_variables()
    for key, val in var.items():
        if val == "":
            var[key] = "x" if key != "resolution" else 1
    var.update(overrides)
    return var


def test_plot_keys_may_be_empty():
    """An empty plot key turns that plot off instead of failing the
    check; every other key is still required."""
    plot_keys = (
        "savePlotsDirectory", "avgClusterPlot", "avgClusterPlot_outlined",
        "fullGenomePlot", "chromosomePlotSuffix", "fullGenomePlotTitle",
    )
    var = _all_set(**{key: "" for key in plot_keys})
    assert config.ensure_all_variables_are_set(var) is False
    var["binGroupFile"] = ""
    assert config.ensure_all_variables_are_set(var) is True


def test_plot_without_matplotlib_fails_check(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert config.ensure_all_variables_are_set(_all_set()) is True
    assert "matplotlib is not installed" in capsys.readouterr().out
    no_plots = _all_set(
        savePlotsDirectory="", avgClusterPlot="", avgClusterPlot_outlined="",
        fullGenomePlot="",
    )
    assert config.ensure_all_variables_are_set(no_plots) is False
