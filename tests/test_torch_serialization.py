"""The port's serialization (``tfhe_tpu_torch/utils/serialization.py``) on the
CPU: the six round trips of tests/test_utils.py, and files that interchange
both ways with the JAX package.  Every comparison is bit-exact u32 equality."""

import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch

import tfhe_tpu as jtfhe
import tfhe_tpu_torch as tfhe
from tfhe_tpu.params import PARAMS as J_PARAMS
from tfhe_tpu.utils import serialization as jser
from tfhe_tpu_torch.ops.torus import to_numpy_u32
from tfhe_tpu_torch.utils import serialization as ser

TEST = tfhe.get_params("test_insecure")
NANO = tfhe.get_params("nano")


@pytest.fixture(scope="module")
def keys():
    return tfhe.keygen(TEST, 5, device="cpu")


class TestSerialization:
    def test_params_json_roundtrip(self):
        s = ser.params_to_json(TEST)
        assert ser.params_from_json(s) == TEST

    def test_client_key_roundtrip(self, keys, tmp_path):
        ck, _ = keys
        p = tmp_path / "ck.npz"
        ser.save_client_key(p, ck)
        back = ser.load_client_key(p, device="cpu")
        assert torch.equal(back.lwe_sk, ck.lwe_sk)
        assert torch.equal(back.glwe_sk, ck.glwe_sk)
        assert back.params == TEST

    def test_server_key_roundtrip_rebuilds_layouts(self, keys, tmp_path):
        _, sk = keys
        p = tmp_path / "sk.npz"
        ser.save_server_key(p, sk)
        back = ser.load_server_key(p, device="cpu")
        for f in ("bk_u32", "bk_lm", "ksk_u32", "ksk_mat"):
            assert torch.equal(getattr(back, f), getattr(sk, f)), f
        assert back.bk_bmmp_lm is None and back.params == TEST

    def test_loaded_server_key_still_computes(self, keys, tmp_path):
        ck, sk = keys
        p = tmp_path / "sk.npz"
        ser.save_server_key(p, sk)
        back = ser.load_server_key(p, device="cpu")
        bits = np.array([0, 1, 1, 0], dtype=np.uint32)
        out = tfhe.gates.nand(back, tfhe.encrypt(ck, bits, 1), tfhe.encrypt(ck, bits, 2))
        assert np.array_equal(to_numpy_u32(tfhe.decrypt(ck, out)), 1 - (bits & bits))

    def test_server_key_bmmp_roundtrip(self, tmp_path):
        """A saved BMMP server key stays a BMMP key."""
        ck, sk = tfhe.keygen(TEST, 6, device="cpu", bmmp=True)
        p = tmp_path / "sk_bmmp.npz"
        ser.save_server_key(p, sk)
        back = ser.load_server_key(p, device="cpu")
        assert back.bk_bmmp_lm is not None
        assert torch.equal(back.bk_bmmp_lm, sk.bk_bmmp_lm)
        bits = np.array([0, 1], dtype=np.uint32)
        out = tfhe.gates.gate(back, "nand", tfhe.encrypt(ck, bits, 3),
                              tfhe.encrypt(ck, bits, 4), impl="bmmp")
        assert np.array_equal(to_numpy_u32(tfhe.decrypt(ck, out)), 1 - (bits & bits))

    def test_ciphertext_roundtrip(self, keys, tmp_path):
        ck, _ = keys
        cts = tfhe.encrypt(ck, np.array([1, 2, 3], np.uint32), 9)
        p = tmp_path / "ct.npz"
        ser.save_ciphertexts(p, cts, TEST)
        back, params = ser.load_ciphertexts(p, device="cpu")
        assert params == TEST
        assert torch.equal(back, cts)

    def test_files_hold_uint32(self, keys, tmp_path):
        """Every array is written as np.uint32, never as the int32 carrier."""
        ck, sk = keys
        ser.save_client_key(tmp_path / "ck.npz", ck)
        ser.save_server_key(tmp_path / "sk.npz", sk)
        ser.save_ciphertexts(tmp_path / "ct.npz", tfhe.encrypt(ck, np.array([1]), 1), TEST)
        for name in ("ck", "sk", "ct"):
            with np.load(tmp_path / f"{name}.npz") as z:
                for field in z.files:
                    if field != "params":
                        assert z[field].dtype == np.uint32, (name, field)

    def test_loader_refuses_another_dtype(self, keys, tmp_path):
        """A file whose u32 array is int32 is refused, not read by value."""
        ck, _ = keys
        cts = tfhe.encrypt(ck, np.array([1, 0]), 1)
        p = tmp_path / "ct_int32.npz"
        np.savez_compressed(p, data=cts.numpy(), params=np.array(ser.params_to_json(TEST)))
        with pytest.raises(ValueError, match="uint32"):
            ser.load_ciphertexts(p, device="cpu")

    def test_loaders_default_to_the_card(self, keys, tmp_path):
        """Loaders put what they read on the card unless asked for another
        device; without a card, a load without ``device=`` raises torch's
        own error instead of carrying on on the CPU."""
        for fn in (ser.load_client_key, ser.load_server_key, ser.load_ciphertexts):
            assert inspect.signature(fn).parameters["device"].default == "cuda"
        if torch.cuda.is_available():
            return
        ck, sk = keys
        ser.save_client_key(tmp_path / "ck.npz", ck)
        with pytest.raises((AssertionError, RuntimeError)):
            ser.load_client_key(tmp_path / "ck.npz")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX keys at nano with the BMMP key, and their client, server and
    ciphertext files written by the JAX package."""
    d = tmp_path_factory.mktemp("jax_files")
    jnano = J_PARAMS["nano"]
    jck, jsk = jtfhe.keygen(jnano, jax.random.key(3), bmmp=True)
    a = np.array([0, 0, 1, 1, 0, 1], np.uint32)
    b = np.array([0, 1, 0, 1, 1, 1], np.uint32)
    ca, cb = jtfhe.encrypt(jck, a, key=1), jtfhe.encrypt(jck, b, key=2)
    jser.save_client_key(d / "client.npz", jck)
    jser.save_server_key(d / "server.npz", jsk)
    jser.save_ciphertexts(d / "a.npz", ca, jnano)
    jser.save_ciphertexts(d / "b.npz", cb, jnano)
    want = np.asarray(jtfhe.gates.nand(jsk, ca, cb, impl="conv"))
    return d, jck, jsk, 1 - (a & b), want


class TestAcrossPackages:
    @pytest.mark.parametrize("impl", ["fused", "conv", "fusedl", "nttf", "fusedp"])
    def test_jax_files_give_jax_gates(self, jax_side, impl):
        """Client, server and ciphertext files written by the JAX package,
        loaded by the port: the port's gates equal the JAX package's bit for
        bit on the same ciphertexts, and decrypt with the loaded client key."""
        d, _, _, clear, want = jax_side
        ck = ser.load_client_key(d / "client.npz", device="cpu")
        sk = tfhe.with_key_form(ser.load_server_key(d / "server.npz", device="cpu"), impl)
        (ca, pa), (cb, pb) = (ser.load_ciphertexts(d / f, device="cpu")
                              for f in ("a.npz", "b.npz"))
        assert pa == pb == sk.params == ck.params == NANO
        out = tfhe.gates.nand(sk, ca, cb, impl=impl)
        assert np.array_equal(to_numpy_u32(out), want)
        assert np.array_equal(to_numpy_u32(tfhe.decrypt(ck, out)), clear)

    def test_port_files_load_into_jax(self, jax_side, tmp_path):
        """Files written by the port, loaded by the JAX package: the arrays
        equal the originals as uint32, and JAX's rebuilt layouts equal its own."""
        _, jck, jsk, _, _ = jax_side
        ck, sk = tfhe.keys_from_numpy(NANO, np.asarray(jck.lwe_sk), np.asarray(jck.glwe_sk),
                                      np.asarray(jsk.bk_u32), np.asarray(jsk.ksk_u32),
                                      device="cpu", bk_bmmp_lm=np.asarray(jsk.bk_bmmp_lm))
        ser.save_client_key(tmp_path / "client.npz", ck)
        ser.save_server_key(tmp_path / "server.npz", sk)
        cts = tfhe.encrypt(ck, np.array([1, 0, 1]), 7)
        ser.save_ciphertexts(tmp_path / "ct.npz", cts, NANO)

        jck2 = jser.load_client_key(tmp_path / "client.npz")
        jsk2 = jser.load_server_key(tmp_path / "server.npz")
        jcts, jp = jser.load_ciphertexts(tmp_path / "ct.npz")
        assert jck2.params == jsk2.params == jp == J_PARAMS["nano"]
        for got, orig in ((jck2.lwe_sk, jck.lwe_sk), (jck2.glwe_sk, jck.glwe_sk),
                          (jsk2.bk_u32, jsk.bk_u32), (jsk2.ksk_u32, jsk.ksk_u32),
                          (jsk2.bk_bmmp_lm, jsk.bk_bmmp_lm), (jcts, to_numpy_u32(cts))):
            assert got.dtype == np.uint32
            assert np.array_equal(np.asarray(got), np.asarray(orig))
        for f in ("bk_lm", "bk_conv", "ksk_mat"):
            assert np.array_equal(np.asarray(getattr(jsk2, f)), np.asarray(getattr(jsk, f))), f
        assert np.array_equal(np.asarray(jtfhe.decrypt(jck2, jcts)), [1, 0, 1])

    @pytest.mark.parametrize("name", sorted(tfhe.PARAMS))
    def test_params_json_matches_jax(self, name):
        """``params_to_json`` gives the JAX package's string for every
        parameter set, and each package reads the other's."""
        ours = ser.params_to_json(tfhe.PARAMS[name])
        assert ours == jser.params_to_json(J_PARAMS[name])
        assert ser.params_from_json(jser.params_to_json(J_PARAMS[name])) == tfhe.PARAMS[name]
        assert dataclasses.asdict(jser.params_from_json(ours)) == dataclasses.asdict(
            tfhe.PARAMS[name])
