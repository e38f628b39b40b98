"""The frozen stream generators: at the recipe's own seeds (run seed 0)
they give the port's distinct HE-AAC v2 streams and the repository's
stereo HE-AAC v1 test streams byte for byte; another run seed gives
other streams, the same seed the same."""
import os

import pytest

from hebench.gen import make_streams
from hebench.harness import load_json
from hebench.tests.conftest import ROOT

V2 = load_json(ROOT, "hebench", "configs", "heaacv2_48k.json")["generator"]
V1 = load_json(ROOT, "hebench", "configs",
               "heaacv1_stereo_48k.json")["generator"]


def test_v2_equals_port_recipe():
    from heaac_tpu_torch.io.heaac_testgen import distinct_stream
    cores = []
    for i in range(8):
        with open(os.path.join(ROOT, "benchdata",
                               f"lc_core_24k_{i}.aac"), "rb") as f:
            cores.append(f.read())
    got = make_streams(ROOT, V2, 10, 0, (0, 1, 2, 3))
    for i in range(10):
        assert got[i] == distinct_stream(cores, i, invf_modes=(0, 1, 2, 3))


def test_v1_stereo_equals_committed_streams():
    got = make_streams(ROOT, V1, 8, 0, (0,))
    for i in range(8):
        with open(os.path.join(ROOT, "tests", "data",
                               f"heaac_v1_stereo_{i}.aac"), "rb") as f:
            assert got[i] == f.read()


@pytest.mark.parametrize("gen", [V2, V1], ids=["v2", "v1_stereo"])
def test_seed_moves_streams(gen):
    a = make_streams(ROOT, gen, 4, 3000000001, (0, 1, 2, 3))
    b = make_streams(ROOT, gen, 4, 3000000002, (0, 1, 2, 3))
    again = make_streams(ROOT, gen, 4, 3000000001, (0, 1, 2, 3))
    assert a == again
    assert all(x != y for x, y in zip(a, b))
    assert len(set(a)) == 4


def test_pool_gives_the_same_streams():
    one = make_streams(ROOT, V2, 6, 17, (0, 1, 2, 3), workers=1)
    two = make_streams(ROOT, V2, 6, 17, (0, 1, 2, 3), workers=2)
    assert one == two
