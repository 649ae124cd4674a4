"""Reading a trace: busy time is the union of the device's operations, and
each idle gap goes to the deepest host operation open at its middle."""

from portbench.tracing import Trace


def test_busy_union_and_idle_gaps():
    device = [("k1", 0, 100), ("k2", 50, 100),       # overlap: busy 0-150
              ("k3", 200, 50),                        # gap 150-200
              ("k1", 400, 100)]                       # gap 250-400
    host = [("aten::where", 140, 80),                 # open at 175
            ("cudaLaunchKernel", 160, 30),            # deepest at 175
            ("aten::item", 300, 20)]                  # closed before 325
    t = Trace(device, host, window_s=1e-6)
    assert t.busy_s() == 300 / 1e9
    assert t.device_time_s(lambda n: n == "k1") == 200 / 1e9
    assert t.top_device_ops(2) == [["k1", 200 / 1e9], ["k2", 100 / 1e9]]
    assert t.idle_gaps() == [["host between operations", 150 / 1e9],
                             ["cudaLaunchKernel", 50 / 1e9]]
