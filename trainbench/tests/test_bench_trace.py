"""The trace reduction on a made-up timeline."""
from trainbench.trace import Timeline, top


def _timeline():
    device = [("gemm", 0.10, 0.30), ("encode_kernel", 0.25, 0.40),
              ("decode_kernel", 0.60, 0.70), ("gemm", 0.90, 1.20)]
    host = [("trainbench.train_step", 0.0, 0.5),
            ("trainbench.round", 0.5, 1.0), ("cudaMemcpy", 0.72, 0.85)]
    return Timeline(device, host, 0.0, 1.0)


def test_busy_is_the_union_clipped_to_the_window():
    tl = _timeline()
    assert abs(tl.busy_s - (0.30 + 0.10 + 0.10)) < 1e-12
    assert tl.window_s == 1.0


def test_kernel_seconds_by_name_and_start():
    tl = _timeline()
    assert abs(tl.kernel_seconds("encode_kernel") - 0.15) < 1e-12
    assert abs(tl.kernel_seconds("_kernel", 0.5, 1.0) - 0.10) < 1e-12


def test_idle_gaps_by_the_innermost_host_span():
    idle = _timeline().idle_by_host()
    # gaps [0, .1], [.4, .6] and [.7, .9]; at .8 the copy is innermost
    assert abs(idle["trainbench.train_step"] - 0.1) < 1e-12
    assert abs(idle["trainbench.round"] - 0.2) < 1e-12
    assert abs(idle["cudaMemcpy"] - 0.2) < 1e-12
    assert top(idle, 1)[0][1] == max(idle.values())


def test_short_names_drop_the_argument_list():
    from trainbench.trace import short
    assert short("void (anonymous namespace)::k<float>(float const*, int)") \
        == "void (anonymous namespace)::k<float>"
    assert short("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"
    assert short("nvjet_tst_256x128") == "nvjet_tst_256x128"
