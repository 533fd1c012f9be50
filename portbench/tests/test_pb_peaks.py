"""The rooflines' arithmetic on known shapes."""
import peaks


def test_bound_takes_the_larger_time():
    b = peaks.bound(3.35e9, 0.0)
    assert abs(b["bound_ms"] - 1.0) < 1e-12 and b["bound_by"] == "bytes"
    b = peaks.bound(1.0, 67e9)
    assert abs(b["bound_ms"] - 1.0) < 1e-12 and b["bound_by"] == "operations"


def test_k1_bytes_of_a_frame():
    # 2 x 2 pixels at depth 3: 4 x (24 + 6) words; 34 pack rows; 16 light rows
    assert peaks.k1_frame_bytes(2, 2, 3, 34, 16) == 4 * 4 * 30 + 34 * 192 + 16 * 52


def test_the_bytes_grow_with_the_frame_and_not_with_its_content():
    one = peaks.k1_frame_bytes(1280, 720, 3, 34, 16)
    assert peaks.k1_frame_bytes(2560, 720, 3, 34, 16) - one == 1280 * 720 * 4 * 30
    assert peaks.k1_frame_bytes(1280, 720, 3, 35, 16) - one == 192
