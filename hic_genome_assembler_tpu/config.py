"""Config system: ``key = value`` template parsing, defaults, validation.

Behavior-compatible with the reference config parser
(run_hicAssembler.py:9-245):

* lines are split on the literal three-character separator ``' = '``;
* blank lines and lines starting with ``#`` are skipped;
* output-file keys are prefixed with ``saveFilesDirectory`` /
  ``savePlotsDirectory`` *at parse time*, so the directory keys must
  appear before any key that depends on them (same ordering contract as
  the reference);
* malformed numeric values warn and keep the default (same messages'
  intent, not byte-identical text);
* every key must end up non-empty or validation fails, and setting both
  ``hyperGeom`` and ``hmm`` to True is a fatal configuration error
  (run_hicAssembler.py:221-245).  One deviation: the plot keys may be
  left empty, which turns that plot off (an empty ``savePlotsDirectory``
  turns off the per-chromosome plots); a set plot key needs matplotlib,
  and validation fails up front when it is missing.
"""

from __future__ import annotations

import importlib.util
import sys
from typing import Any, Dict

# Keys whose value is prefixed with saveFilesDirectory at parse time
# (run_hicAssembler.py:82-98,184-185,212-215).
_FILES_DIR_KEYS = (
    "chromosomeGroupFile",
    "chromosomeOrderFile",
    "finalOrderingsFile",
    "dendrogramOrderFile",
    "binGroupFile",
    "assessmentFile",
    "plotOrderFile",
    "assembledFastaFile",
)

# Keys whose value is prefixed with savePlotsDirectory at parse time
# (run_hicAssembler.py:91-94,180-181).
_PLOTS_DIR_KEYS = (
    "avgClusterPlot",
    "avgClusterPlot_outlined",
    "fullGenomePlot",
)

# Plain string keys copied through verbatim.
_PLAIN_KEYS = (
    "saveFilesDirectory",
    "savePlotsDirectory",
    "hicProBedFile",
    "hicProBiasFile",
    "hicProMatrixFile",
    "hicProScaffSizeFile",
    "chromosomePlotSuffix",
    "fullGenomePlotTitle",
    "restrictionSiteFile",
    "validPairFile",
    "originalFastaFile",
)

# Plot keys that may stay empty (that plot is then skipped).
_OPTIONAL_PLOT_KEYS = (
    "savePlotsDirectory",
    "chromosomePlotSuffix",
    "fullGenomePlotTitle",
) + _PLOTS_DIR_KEYS

_INT_KEYS = {
    "minSize": 5,
    "convergenceRounds": 5,
    "louvainRounds": 20,
    "nScaffolds": 6,
    "scanScaffolds": 5,
    "lengthCutoff": 500000,
}


def default_variables() -> Dict[str, Any]:
    """The full key set with defaults (run_hicAssembler.py:14-47)."""
    var: Dict[str, Any] = {key: "" for key in _PLAIN_KEYS}
    var.update({key: "" for key in _FILES_DIR_KEYS})
    var.update({key: "" for key in _PLOTS_DIR_KEYS})
    var.update(
        {
            "resolution": "",
            "hyperGeom": True,
            "hmm": False,
            "minSize": 5,
            "modularity": 0.05,
            "psig": 0.05,
            "convergenceRounds": 5,
            "lookAhead": 0.2,
            "louvainRounds": 20,
            "nScaffolds": 6,
            "scanScaffolds": 5,
            "lengthCutoff": 500000,
            # Framework extension (not in the reference template; has a
            # non-empty default so existing configs stay valid):
            # part-1 transform precision — "exact" = host f64 with
            # reference-identical tie behavior, "device" = fast on-device
            # transforms + rank argsort.
            "matrixMode": "exact",
            # Framework extension: HMM-branch EM implementation —
            # "fast" = shape-bucketed masked EM + fused Viterbi (one
            # dispatch/round), "exact" = unpadded per-shape EM
            # (rounds-2-4 bit-continuity).
            "hmmMode": "fast",
        }
    )
    return var


def _parse_bool(val: str):
    if val in ("True", "true"):
        return True
    if val in ("False", "false"):
        return False
    return None


def read_config_file_to_variables(config_file: str) -> Dict[str, Any]:
    """Parse a reference-format config file into the variable dict.

    Mirrors run_hicAssembler.py:9-219 key-for-key, including the
    parse-time path prefixing and the warn-and-keep-default coercion of
    numeric keys.
    """
    var = default_variables()
    with open(config_file, "r") as handle:
        for raw in handle:
            line = raw.strip("\r").strip("\n")
            if line == "" or line[0] == "#":
                continue
            if " = " not in line:
                continue
            arg, val = line.split(" = ")[0], line.split(" = ")[1]
            if not val:
                continue

            if arg == "resolution":
                try:
                    var["resolution"] = int(val)
                except ValueError:
                    print(
                        "ERROR... resolution must be an integer value equal to "
                        "the resolution of the contact map used. Exiting..."
                    )
                    sys.exit(1)
            elif arg in _PLAIN_KEYS:
                var[arg] = val
            elif arg in _FILES_DIR_KEYS:
                var[arg] = var["saveFilesDirectory"] + "/" + val
            elif arg in _PLOTS_DIR_KEYS:
                var[arg] = var["savePlotsDirectory"] + "/" + val
            elif arg in ("hyperGeom", "hmm"):
                parsed = _parse_bool(val)
                if parsed is not None:
                    var[arg] = parsed
            elif arg in _INT_KEYS:
                try:
                    var[arg] = int(val)
                except ValueError:
                    print(
                        "WARNING... {} must be an integer value... keeping the "
                        "default of {}".format(arg, _INT_KEYS[arg])
                    )
            elif arg == "modularity":
                try:
                    fval = float(val)
                    if fval > 1.0:
                        print(
                            "WARNING... modularity must be a value between 0.0 "
                            "and 1.0... setting modularity=.05 (default)"
                        )
                        fval = 0.05
                    var["modularity"] = fval
                except ValueError:
                    print(
                        "WARNING... modularity must be a floating point "
                        "value... keeping the default of .05"
                    )
            elif arg == "psig":
                try:
                    fval = float(val)
                    if fval > 1.0:
                        print(
                            "WARNING... psig must be a value between 0.0 and "
                            "1.0... keeping the default of .05"
                        )
                    else:
                        var["psig"] = fval
                except ValueError:
                    print(
                        "WARNING... psig must be a floating point value... "
                        "keeping the default of .05"
                    )
            elif arg == "matrixMode":
                if val in ("exact", "device"):
                    var["matrixMode"] = val
                else:
                    print(
                        'WARNING... matrixMode must be "exact" or "device"... '
                        'keeping the default of "exact"'
                    )
            elif arg == "hmmMode":
                if val in ("fast", "exact"):
                    var["hmmMode"] = val
                else:
                    print(
                        'WARNING... hmmMode must be "fast" or "exact"... '
                        'keeping the default of "fast"'
                    )
            elif arg == "lookAhead":
                try:
                    fval = float(val)
                    if fval > 1.0:
                        print(
                            "WARNING... lookAhead must be a value between 0.0 "
                            "and 1.0 or \"False\"; {} is out of bounds... "
                            "keeping the default of .2".format(val)
                        )
                        fval = 0.2
                    var["lookAhead"] = fval
                except ValueError:
                    parsed = _parse_bool(val)
                    if parsed is False:
                        var["lookAhead"] = False
                    else:
                        print(
                            "WARNING... lookAhead should be \"False\" or a "
                            "float between 0.0 and 1.0... {} is not valid; "
                            "keeping the default of .2".format(val)
                        )
                        var["lookAhead"] = 0.2
    return var


def ensure_all_variables_are_set(var: Dict[str, Any]) -> bool:
    """Return True when the run must abort (run_hicAssembler.py:221-245).

    True iff any required key is still '', both hyperGeom and hmm are
    True, or a plot is requested without matplotlib installed.
    """
    unset = [
        key for key, val in var.items()
        if val == "" and key not in _OPTIONAL_PLOT_KEYS
    ]
    if var["hyperGeom"] is True and var["hmm"] is True:
        print(
            '- WARNING - Both hyperGeom and hmm options are set to True... '
            'Set one option to "True" and the other to "False" or both to '
            '"False" in order to continue. Exiting...'
        )
        return True
    if unset:
        print(
            "The following variable(s) do not have any value associated with "
            "them. Please set these variables to continue."
        )
        for key in unset:
            print(key)
        print("Exiting...")
        return True
    plots = [
        key for key in ("savePlotsDirectory",) + _PLOTS_DIR_KEYS if var[key]
    ]
    if plots and importlib.util.find_spec("matplotlib") is None:
        print(
            "- ERROR - plotting is requested ({}) but matplotlib is not "
            "installed. Install matplotlib or leave these keys empty. "
            "Exiting...".format(", ".join(plots))
        )
        return True
    return False
