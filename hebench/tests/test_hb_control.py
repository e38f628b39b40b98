"""The control of ``correct`` at a test size: the reference with TF32
transforms in the program's place fails each cell's limits (two streams
a cell; on the chip it runs at the cell's own size)."""
import pytest

from hebench.tools import control


@pytest.mark.parametrize("cell", ["v2_batch_512", "v1s_stream_b1",
                                  "v1s_batch_256"])
def test_tf32_control_fails(cell, capsys):
    assert control.main(["--workload", cell, "--seeds", "3000000021",
                         "--streams", "2"]) == 0
    assert '"control_passed": false' in capsys.readouterr().out
