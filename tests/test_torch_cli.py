"""End-to-end CLI workflow tests of the port (``python -m tfhe_tpu_torch.cli``:
keygen -> encrypt -> gate/gate3/lut/add -> decrypt -> noise) with
``--device cpu`` at nano, the cases of tests/test_cli.py, and the port's CLI
on files written by the JAX package's CLI."""

import inspect

import numpy as np
import pytest
import torch

from tfhe_tpu.cli import main as jax_main
from tfhe_tpu_torch import cli
from tfhe_tpu_torch.cli import main


def run(capsys, *argv):
    main(list(argv) + ["--device", "cpu"])
    return capsys.readouterr().out.strip()


@pytest.fixture(scope="module")
def keydir2(tmp_path_factory):
    d = tmp_path_factory.mktemp("keys2")
    main(["keygen", "--params", "nano", "--out", str(d), "--device", "cpu"])
    return d


@pytest.fixture(scope="module")
def keydir3(tmp_path_factory):
    d = tmp_path_factory.mktemp("keys3")
    main(["keygen", "--params", "nano_3in", "--out", str(d), "--device", "cpu"])
    return d


def encrypt_pair(capsys, d, tmp_path, a="0101", b="0011"):
    run(capsys, "encrypt", "--client", f"{d}/client.npz", "--bits", a,
        "--out", f"{tmp_path}/a.npz")
    run(capsys, "encrypt", "--client", f"{d}/client.npz", "--bits", b,
        "--out", f"{tmp_path}/b.npz", "--seed", "2")


class TestCliGate:
    def test_nand_roundtrip(self, keydir2, tmp_path, capsys):
        d = str(keydir2)
        encrypt_pair(capsys, d, tmp_path)
        run(capsys, "gate", "--server", f"{d}/server.npz", "--op", "nand",
            "--lhs", f"{tmp_path}/a.npz", "--rhs", f"{tmp_path}/b.npz",
            "--out", f"{tmp_path}/o.npz", "--impl", "conv")
        out = run(capsys, "decrypt", "--client", f"{d}/client.npz",
                  "--in", f"{tmp_path}/o.npz")
        assert out == "1110"  # nand(0101, 0011)

    def test_not_needs_no_rhs(self, keydir2, tmp_path, capsys):
        d = str(keydir2)
        run(capsys, "encrypt", "--client", f"{d}/client.npz", "--bits", "10",
            "--out", f"{tmp_path}/a.npz")
        run(capsys, "gate", "--server", f"{d}/server.npz", "--op", "not",
            "--lhs", f"{tmp_path}/a.npz", "--out", f"{tmp_path}/o.npz")
        out = run(capsys, "decrypt", "--client", f"{d}/client.npz",
                  "--in", f"{tmp_path}/o.npz")
        assert out == "01"

    def test_noise_report(self, keydir2, tmp_path, capsys):
        d = str(keydir2)
        run(capsys, "encrypt", "--client", f"{d}/client.npz", "--bits", "11",
            "--out", f"{tmp_path}/a.npz")
        out = run(capsys, "noise", "--client", f"{d}/client.npz",
                  "--in", f"{tmp_path}/a.npz", "--expect", "11")
        assert "failures = 0/2" in out

    def test_mux(self, keydir2, tmp_path, capsys):
        d = str(keydir2)
        for name, bits in [("sel", "01"), ("a", "11"), ("b", "00")]:
            run(capsys, "encrypt", "--client", f"{d}/client.npz",
                "--bits", bits, "--out", f"{tmp_path}/{name}.npz")
        run(capsys, "gate", "--server", f"{d}/server.npz", "--op", "mux",
            "--sel", f"{tmp_path}/sel.npz", "--lhs", f"{tmp_path}/a.npz",
            "--rhs", f"{tmp_path}/b.npz", "--out", f"{tmp_path}/o.npz",
            "--impl", "conv")
        out = run(capsys, "decrypt", "--client", f"{d}/client.npz",
                  "--in", f"{tmp_path}/o.npz")
        assert out == "01"  # sel ? a : b

    @pytest.mark.parametrize("impl", ["fusedl", "nttf", "ntt", "bmmpl"])
    def test_loader_attaches_the_impl_key_form(self, keydir2, tmp_path, capsys, impl):
        """The impls that read a derived key form work on a loaded server
        file: the loader attaches it ('bmmpl' on a file without the BMMP key
        raises the port's ValueError instead)."""
        d = str(keydir2)
        encrypt_pair(capsys, d, tmp_path)
        argv = ("gate", "--server", f"{d}/server.npz", "--op", "nand", "--lhs",
                f"{tmp_path}/a.npz", "--rhs", f"{tmp_path}/b.npz", "--out",
                f"{tmp_path}/o.npz", "--impl", impl)
        if impl == "bmmpl":
            with pytest.raises(ValueError, match="BMMP key"):
                run(capsys, *argv)
            return
        run(capsys, *argv)
        out = run(capsys, "decrypt", "--client", f"{d}/client.npz",
                  "--in", f"{tmp_path}/o.npz")
        assert out == "1110"

    def test_mistyped_impl_is_rejected(self, keydir2, tmp_path, capsys):
        with pytest.raises(SystemExit):
            run(capsys, "gate", "--server", f"{keydir2}/server.npz", "--op", "nand",
                "--lhs", f"{tmp_path}/a.npz", "--rhs", f"{tmp_path}/b.npz",
                "--out", f"{tmp_path}/o.npz", "--impl", "fuzed")
        assert "invalid choice: 'fuzed'" in capsys.readouterr().err

    def test_input_that_does_not_fit_raises(self, keydir2, tmp_path, capsys):
        """Digits past 2^log_p and operands of other widths are refused with
        ValueError (the JAX CLI's bare asserts)."""
        d = str(keydir2)
        with pytest.raises(ValueError, match="2\\^log_p"):
            run(capsys, "encrypt", "--client", f"{d}/client.npz", "--bits", "0151",
                "--out", f"{tmp_path}/a.npz")
        encrypt_pair(capsys, d, tmp_path, a="0101", b="011")
        with pytest.raises(ValueError, match="widths differ"):
            run(capsys, "add", "--server", f"{d}/server.npz", "--lhs", f"{tmp_path}/a.npz",
                "--rhs", f"{tmp_path}/b.npz", "--out", f"{tmp_path}/s.npz")


class TestCliGate3:
    def test_mux3(self, keydir3, tmp_path, capsys):
        d = str(keydir3)
        for name, bits in [("s", "01"), ("a", "11"), ("b", "00")]:
            run(capsys, "encrypt", "--client", f"{d}/client.npz",
                "--bits", bits, "--out", f"{tmp_path}/{name}.npz")
        run(capsys, "gate3", "--server", f"{d}/server.npz", "--op", "mux",
            "--in2", f"{tmp_path}/s.npz", "--in1", f"{tmp_path}/a.npz",
            "--in0", f"{tmp_path}/b.npz", "--out", f"{tmp_path}/o.npz",
            "--impl", "conv")
        out = run(capsys, "decrypt", "--client", f"{d}/client.npz",
                  "--in", f"{tmp_path}/o.npz")
        assert out == "01"

    def test_lut(self, keydir3, tmp_path, capsys):
        d = str(keydir3)
        run(capsys, "encrypt", "--client", f"{d}/client.npz", "--bits", "0123",
            "--out", f"{tmp_path}/x.npz")
        # lut[i] = 3 - i over Z_8 inputs 0..3 (rest don't-care zeros)
        run(capsys, "lut", "--server", f"{d}/server.npz",
            "--in", f"{tmp_path}/x.npz", "--lut", "3,2,1,0,0,0,0,0",
            "--out", f"{tmp_path}/o.npz", "--impl", "conv")
        out = run(capsys, "decrypt", "--client", f"{d}/client.npz",
                  "--in", f"{tmp_path}/o.npz")
        assert out == "3210"
        with pytest.raises(ValueError, match="LUT needs"):
            run(capsys, "lut", "--server", f"{d}/server.npz", "--in", f"{tmp_path}/x.npz",
                "--lut", "3,2,1,0", "--out", f"{tmp_path}/o.npz")


class TestCliAdd:
    def test_add_roundtrip(self, keydir2, tmp_path, capsys):
        """4-bit encrypted add via the CLI: 0101 (5) + 0011 (3) = 1000 (8)."""
        d = str(keydir2)
        encrypt_pair(capsys, d, tmp_path)
        run(capsys, "add", "--server", f"{d}/server.npz",
            "--lhs", f"{tmp_path}/a.npz", "--rhs", f"{tmp_path}/b.npz",
            "--out", f"{tmp_path}/s.npz", "--impl", "conv")
        out = run(capsys, "decrypt", "--client", f"{d}/client.npz",
                  "--in", f"{tmp_path}/s.npz")
        assert out == "1000"

    def test_add_carry_out(self, keydir2, tmp_path, capsys):
        """--carry-out emits W+1 bits: 11 (3) + 11 (3) -> 110 (6)."""
        d = str(keydir2)
        encrypt_pair(capsys, d, tmp_path, a="11", b="11")
        run(capsys, "add", "--server", f"{d}/server.npz",
            "--lhs", f"{tmp_path}/a.npz", "--rhs", f"{tmp_path}/b.npz",
            "--out", f"{tmp_path}/s.npz", "--carry-out", "--impl", "conv")
        out = run(capsys, "decrypt", "--client", f"{d}/client.npz",
                  "--in", f"{tmp_path}/s.npz")
        assert out == "110"


class TestAcrossCli:
    @pytest.mark.parametrize("impl", ["conv", "fused"])
    def test_gate_on_jax_cli_files_equals_jax_cli(self, tmp_path, capsys, impl):
        """A server file and ciphertext files written by the JAX CLI, run
        through the port's ``gate``: its ``data`` equals the JAX CLI's output
        on the same files bit for bit, and the port decrypts it."""
        d = str(tmp_path)
        jax_main(["keygen", "--params", "nano", "--out", d])
        jax_main(["encrypt", "--client", f"{d}/client.npz", "--bits", "0101", "--out",
                  f"{d}/a.npz"])
        jax_main(["encrypt", "--client", f"{d}/client.npz", "--bits", "0011", "--out",
                  f"{d}/b.npz", "--seed", "2"])
        files = ["--server", f"{d}/server.npz", "--op", "nand", "--lhs", f"{d}/a.npz",
                 "--rhs", f"{d}/b.npz", "--impl", "conv"]
        jax_main(["gate", *files, "--out", f"{d}/o_jax.npz"])
        files[-1] = impl
        run(capsys, "gate", *files, "--out", f"{d}/o_port.npz")
        with np.load(f"{d}/o_jax.npz") as zj, np.load(f"{d}/o_port.npz") as zp:
            assert zp["data"].dtype == np.uint32
            assert np.array_equal(zp["data"], zj["data"])
            assert str(zp["params"]) == str(zj["params"])
        out = run(capsys, "decrypt", "--client", f"{d}/client.npz", "--in", f"{d}/o_port.npz")
        assert out == "1110"


def test_default_device_is_the_card(tmp_path):
    """Without ``--device`` every subcommand reaches for the card: without
    one, keygen raises torch's own error instead of carrying on on the CPU."""
    for fn in (cli.tfhe.keygen, cli.ser.load_client_key, cli.ser.load_server_key):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        main(["keygen", "--params", "nano", "--out", str(tmp_path)])
        assert (tmp_path / "server.npz").exists()
        return
    with pytest.raises((AssertionError, RuntimeError)):
        main(["keygen", "--params", "nano", "--out", str(tmp_path)])
