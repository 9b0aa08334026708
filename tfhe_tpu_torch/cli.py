"""Command-line interface: keygen / encrypt / gate / decrypt / demo (port of
``tfhe_tpu/cli.py``), the client/server workflow on top of the serialization
layer.  Its files are the JAX package's, so either CLI reads the other's:

    python -m tfhe_tpu_torch.cli keygen  --params default_128 --out keys/
    python -m tfhe_tpu_torch.cli encrypt --client keys/client.npz --bits 1011 --out a.npz
    python -m tfhe_tpu_torch.cli gate    --server keys/server.npz --op nand \\
                                         --lhs a.npz --rhs b.npz --out out.npz
    python -m tfhe_tpu_torch.cli decrypt --client keys/client.npz --in out.npz
    python -m tfhe_tpu_torch.cli demo    --params test_insecure

Every subcommand runs on the card unless given ``--device cpu`` (where the
kernels' plain twins run).  The server-side commands attach the key form
their ``--impl`` reads when they load the server file
(``models/keys.py:with_key_form``).  Encryption draws from torch generators,
so ``encrypt --seed s`` gives other ciphertexts than the JAX CLI's with the
same seed (the same bits decrypt); gates on one ciphertext file give the
same bits in both.  Input that does not fit the parameters (a digit past
2^log_p, a LUT of the wrong length, operands of other widths or parameters)
raises ``ValueError``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

import tfhe_tpu_torch as tfhe
from tfhe_tpu_torch.models import circuits as mcirc
from tfhe_tpu_torch.models import test_vector as mtv
from tfhe_tpu_torch.models.bootstrap import VALID_IMPLS
from tfhe_tpu_torch.ops.torus import to_numpy_u32
from tfhe_tpu_torch.utils import noise as unoise
from tfhe_tpu_torch.utils import serialization as ser
from tfhe_tpu_torch.utils.profiling import Timer


def cmd_keygen(args):
    params = tfhe.get_params(args.params)
    timer = Timer()
    ck, sk = tfhe.keygen(params, args.seed, device=args.device)
    keygen_s = timer.mark("keygen", sk.bk_u32)
    os.makedirs(args.out, exist_ok=True)
    ser.save_client_key(os.path.join(args.out, "client.npz"), ck)
    ser.save_server_key(os.path.join(args.out, "server.npz"), sk)
    save_s = timer.mark("save")
    print(f"keygen({params.name}) in {keygen_s:.1f}s, saved in {save_s:.1f}s -> "
          f"{args.out}/{{client,server}}.npz")


def _digits(text: str, log_p: int, what: str) -> np.ndarray:
    digits = np.array([int(c) for c in text], dtype=np.uint32)
    if np.any(digits >= (1 << log_p)):
        raise ValueError(f"{what} {text!r} holds a digit >= 2^log_p = {1 << log_p}")
    return digits


def cmd_encrypt(args):
    ck = ser.load_client_key(args.client, args.device)
    bits = _digits(args.bits, ck.params.log_p, "--bits")
    cts = tfhe.encrypt(ck, bits, args.seed)
    ser.save_ciphertexts(args.out, cts, ck.params)
    print(f"encrypted {len(bits)} messages -> {args.out}")


def _load_server(args):
    return tfhe.with_key_form(ser.load_server_key(args.server, args.device), args.impl)


def _load_cts(path, params, device):
    cts, p = ser.load_ciphertexts(path, device)
    if p != params:
        raise ValueError(f"parameter mismatch for {path}: {p.name}, expected {params.name}")
    return cts


def cmd_gate(args):
    sk = _load_server(args)
    lhs = _load_cts(args.lhs, sk.params, args.device)
    timer = Timer()
    if args.op == "not":
        out = tfhe.gates.not_(sk, lhs)
        what = f"not on {lhs.shape[0]} ciphertexts"
    else:
        rhs = _load_cts(args.rhs, sk.params, args.device)
        if args.op == "mux":
            sel = _load_cts(args.sel, sk.params, args.device)
            out = tfhe.gates.mux(sk, sel, lhs, rhs, impl=args.impl)
        else:
            # index = 2*lhs + rhs
            out = tfhe.gates.gate(sk, args.op, rhs, lhs, impl=args.impl)
        what = f"{args.op} on {lhs.shape[0]} ciphertext pairs"
    seconds = timer.mark(args.op, out)
    ser.save_ciphertexts(args.out, out, sk.params)
    print(f"{what} in {seconds:.1f}s -> {args.out}")


def cmd_gate3(args):
    sk = _load_server(args)
    if sk.params.log_p < 3:
        raise ValueError("3-input gates need a log_p>=3 parameter set")
    c2 = _load_cts(args.in2, sk.params, args.device)
    c1 = _load_cts(args.in1, sk.params, args.device)
    c0 = _load_cts(args.in0, sk.params, args.device)
    timer = Timer()
    out = tfhe.gates.gate3(sk, args.op, c2, c1, c0, impl=args.impl)
    seconds = timer.mark(args.op, out)
    ser.save_ciphertexts(args.out, out, sk.params)
    print(f"{args.op} on {c0.shape[0]} ciphertext triples in {seconds:.1f}s -> {args.out}")


def cmd_lut(args):
    sk = _load_server(args)
    cts = _load_cts(args.infile, sk.params, args.device)
    lut = [int(c) for c in args.lut.split(",")]
    if len(lut) != 1 << sk.params.log_p:
        raise ValueError(f"LUT needs 2^log_p = {1 << sk.params.log_p} entries, got {len(lut)}")
    timer = Timer()
    out = tfhe.gates.apply_lut(sk, cts, lut, impl=args.impl)
    seconds = timer.mark("lut", out)
    ser.save_ciphertexts(args.out, out, sk.params)
    print(f"lut on {cts.shape[0]} ciphertexts in {seconds:.1f}s -> {args.out}")


def cmd_add(args):
    """Encrypted W-bit ripple-carry addition (models/circuits.py): inputs are
    ciphertext files whose W ciphertexts are one integer's bits MSB-first (as
    produced by ``encrypt --bits``); output is the W sum bits MSB-first
    (modular: carry-out dropped unless --carry-out)."""
    sk = _load_server(args)
    lhs = _load_cts(args.lhs, sk.params, args.device)
    rhs = _load_cts(args.rhs, sk.params, args.device)
    if lhs.shape != rhs.shape:
        raise ValueError(f"operand widths differ: {lhs.shape[0]} and {rhs.shape[0]} bits")
    w = lhs.shape[0]
    timer = Timer()
    s, cout = mcirc.ripple_carry_add(
        sk, torch.flip(lhs, (0,))[:, None], torch.flip(rhs, (0,))[:, None], impl=args.impl)
    out = torch.flip(s[:, 0], (0,))
    if args.carry_out:
        out = torch.cat([cout, out])  # W+1 bits MSB-first
    seconds = timer.mark("add", out)
    ser.save_ciphertexts(args.out, out, sk.params)
    boots = 5 * w if sk.params.log_p == 2 else 2 * w
    print(f"{w}-bit add ({boots} bootstraps) in {seconds:.1f}s -> {args.out}")


def cmd_noise(args):
    ck = ser.load_client_key(args.client, args.device)
    cts = _load_cts(args.infile, ck.params, args.device)
    if args.expect:
        want = _digits(args.expect, ck.params.log_p, "--expect")
        if want.shape[0] != cts.shape[0]:
            raise ValueError(f"--expect has {want.shape[0]} digits for {cts.shape[0]} "
                             "ciphertexts")
    else:
        # measure against whatever the ciphertexts decode to (margin only)
        want = to_numpy_u32(tfhe.decrypt(ck, cts))
    print(unoise.measure(ck, cts, want))


def cmd_decrypt(args):
    ck = ser.load_client_key(args.client, args.device)
    cts = _load_cts(args.infile, ck.params, args.device)
    bits = to_numpy_u32(tfhe.decrypt(ck, cts))
    print("".join(str(int(b)) for b in bits))


def cmd_demo(args):
    params = tfhe.get_params(args.params)
    print(f"params: {params.name} (n={params.lwe_dimension}, k={params.glwe_dimension}, "
          f"N={params.degree}) on {args.device}")
    timer = Timer()
    ck, sk = tfhe.keygen(params, 0, device=args.device)
    print(f"keygen: {timer.mark('keygen', sk.bk_u32):.1f}s "
          f"(bk {sk.bk_u32.numel() * 4 / 1e6:.1f} MB)")
    rng = np.random.default_rng(args.seed)
    a = rng.integers(0, 2, size=8).astype(np.uint32)
    b = rng.integers(0, 2, size=8).astype(np.uint32)
    ca = tfhe.encrypt(ck, a, 1)
    cb = tfhe.encrypt(ck, b, 2)
    timer.mark("encrypt", ca, cb)
    for op in ("and", "xor", "nand"):
        got = to_numpy_u32(tfhe.decrypt(ck, tfhe.gates.gate(sk, op, cb, ca)))
        want = np.array([mtv.GATE_FNS[op](int(x), int(y)) for x, y in zip(a, b)])
        ok = "OK" if np.array_equal(got, want) else "MISMATCH"
        print(f"{op:5s}({a.tolist()},{b.tolist()}) = {got.tolist()} [{ok}] "
              f"({timer.mark(op):.1f}s)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tfhe_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="torch device to compute on (default: the card)")

    def command(name, fn):
        p = sub.add_parser(name, parents=[common])
        p.set_defaults(fn=fn)
        return p

    kg = command("keygen", cmd_keygen)
    kg.add_argument("--params", default="default_128")
    kg.add_argument("--out", required=True)
    kg.add_argument("--seed", type=int, default=0)

    en = command("encrypt", cmd_encrypt)
    en.add_argument("--client", required=True)
    en.add_argument("--bits", required=True, help="e.g. 1011")
    en.add_argument("--out", required=True)
    en.add_argument("--seed", type=int, default=1)

    #: every library backend is reachable from the CLI (the bench exposes the
    #: same list): the port's VALID_IMPLS in models/bootstrap.py
    impls = list(VALID_IMPLS)

    ga = command("gate", cmd_gate)
    ga.add_argument("--server", required=True)
    ga.add_argument("--op", required=True, choices=sorted(list(mtv.GATE_FNS) + ["not", "mux"]))
    ga.add_argument("--lhs", required=True)
    ga.add_argument("--rhs", help="required for binary gates (not for 'not')")
    ga.add_argument("--sel", help="selector ciphertexts (mux only)")
    ga.add_argument("--out", required=True)
    ga.add_argument("--impl", default="auto", choices=impls)

    g3 = command("gate3", cmd_gate3)
    g3.add_argument("--server", required=True)
    g3.add_argument("--op", required=True, choices=sorted(mtv.GATE3_FNS))
    g3.add_argument("--in2", required=True, help="MSB input (e.g. mux selector)")
    g3.add_argument("--in1", required=True)
    g3.add_argument("--in0", required=True, help="LSB input")
    g3.add_argument("--out", required=True)
    g3.add_argument("--impl", default="auto", choices=impls)

    lu = command("lut", cmd_lut)
    lu.add_argument("--server", required=True)
    lu.add_argument("--in", dest="infile", required=True)
    lu.add_argument("--lut", required=True,
                    help="comma-separated 2^log_p outputs, e.g. 0,1,1,0... ")
    lu.add_argument("--out", required=True)
    lu.add_argument("--impl", default="auto", choices=impls)

    ad = command("add", cmd_add)
    ad.add_argument("--server", required=True)
    ad.add_argument("--lhs", required=True, help="W bit ciphertexts, MSB-first")
    ad.add_argument("--rhs", required=True)
    ad.add_argument("--out", required=True)
    ad.add_argument("--carry-out", action="store_true",
                    help="emit W+1 bits (keep the carry)")
    ad.add_argument("--impl", default="auto", choices=impls)

    no = command("noise", cmd_noise)
    no.add_argument("--client", required=True)
    no.add_argument("--in", dest="infile", required=True)
    no.add_argument("--expect", default="",
                    help="expected cleartext digits, e.g. 1011 (default: "
                    "measure against the decoded values)")

    de = command("decrypt", cmd_decrypt)
    de.add_argument("--client", required=True)
    de.add_argument("--in", dest="infile", required=True)

    dm = command("demo", cmd_demo)
    dm.add_argument("--params", default="test_insecure")
    dm.add_argument("--seed", type=int, default=7)

    args = ap.parse_args(argv)
    if args.cmd == "gate":
        if args.op == "mux" and args.sel is None:
            ap.error("--sel required for mux")
        if args.op != "not" and args.rhs is None:
            ap.error("--rhs required for binary gates")
    args.fn(args)


if __name__ == "__main__":
    main()
