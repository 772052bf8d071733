"""Execute the example notebook headlessly (VERDICT r1 item 9).

The reference's notebook is its only integration harness (SURVEY.md §4);
ours must actually run, not just exist.  Executed with nbclient on a
fresh kernel; any raising cell fails the test.
"""

import os

import pytest

NB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "examples",
    "hic_assembler_notebook.ipynb",
)


def test_notebook_executes(tmp_path):
    nbformat = pytest.importorskip("nbformat")
    nbclient = pytest.importorskip("nbclient")

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    nb = nbformat.read(NB_PATH, as_version=4)
    # the kernel subprocess inherits os.environ: put the repo on its
    # path and force the CPU platform (same policy as conftest)
    old_pp = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = repo_root + (os.pathsep + old_pp if old_pp else "")
    os.environ["JAX_PLATFORMS"] = "cpu"
    try:
        client = nbclient.NotebookClient(
            nb,
            timeout=600,
            kernel_name="python3",
            resources={"metadata": {"path": str(tmp_path)}},
        )
        client.execute()
    finally:
        if old_pp is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = old_pp
    executed = [c for c in nb.cells if c.cell_type == "code"]
    assert executed, "notebook has no code cells"
    for cell in executed:
        for out in cell.get("outputs", []):
            assert out.get("output_type") != "error", out
