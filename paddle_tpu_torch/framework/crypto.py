"""Model-file encryption.

A copy of ``paddle_tpu/framework/crypto.py`` (which imports no JAX):
the same format and functions, so a file that one package encrypts
decrypts in the other.

reference parity: paddle/fluid/framework/io/crypto/cipher.h:24 —
CipherFactory/AesCipher let inference models ship encrypted
(paddle.fluid.io save/load with a cipher). The image has no OpenSSL
python bindings, so the cipher here is a keyed-BLAKE2b PRF in counter
mode with an encrypt-then-MAC tag — a dependency-free authenticated
stream cipher (CTR over a PRF is IND-CPA; the keyed-BLAKE2 MAC over
nonce+ciphertext gives integrity, which the reference's raw AES-CBC
never had: tampered files decrypt to garbage there, here they RAISE).

Format: MAGIC | nonce(16) | ciphertext | tag(32).
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct
from typing import Optional

__all__ = ["Cipher", "CipherFactory", "encrypt_bytes", "decrypt_bytes",
           "encrypt_file", "decrypt_file", "generate_key"]

_MAGIC = b"PTPUENC1"
_NONCE = 16
_TAG = 32
_BLOCK = 64          # blake2b digest size = keystream block


class DecryptionError(ValueError):
    pass


def generate_key(nbytes: int = 32) -> bytes:
    """Random key (reference: CipherUtils::GenKey)."""
    return os.urandom(nbytes)


def _derive(key: bytes, label: bytes) -> bytes:
    return hashlib.blake2b(label, key=key, digest_size=32).digest()


def _keystream_xor(data: bytes, key: bytes, nonce: bytes) -> bytes:
    import numpy as np
    enc_key = _derive(key, b"enc")
    n_blocks = (len(data) + _BLOCK - 1) // _BLOCK
    # keystream assembled blockwise, XOR vectorized over the whole buffer
    # (a per-byte python loop runs single-digit MB/s — checkpoint-sized
    # payloads must stream at memory speed)
    ks = bytearray(n_blocks * _BLOCK)
    for blk in range(n_blocks):
        ctr = struct.pack("<Q", blk)
        ks[blk * _BLOCK:(blk + 1) * _BLOCK] = hashlib.blake2b(
            nonce + ctr, key=enc_key, digest_size=_BLOCK).digest()
    a = np.frombuffer(data, np.uint8)
    b = np.frombuffer(bytes(ks[:len(data)]), np.uint8)
    return np.bitwise_xor(a, b).tobytes()


def encrypt_bytes(plaintext: bytes, key: bytes,
                  nonce: Optional[bytes] = None) -> bytes:
    if not key:
        raise ValueError("empty encryption key")
    nonce = nonce if nonce is not None else os.urandom(_NONCE)
    if len(nonce) != _NONCE:
        raise ValueError(f"nonce must be {_NONCE} bytes")
    ct = _keystream_xor(plaintext, key, nonce)
    mac_key = _derive(key, b"mac")
    tag = hashlib.blake2b(nonce + ct, key=mac_key,
                          digest_size=_TAG).digest()
    return _MAGIC + nonce + ct + tag


def is_encrypted(blob: bytes) -> bool:
    return blob[:len(_MAGIC)] == _MAGIC


def decrypt_bytes(blob: bytes, key: bytes) -> bytes:
    if not is_encrypted(blob):
        raise DecryptionError(
            "not an encrypted model blob (missing magic); load it without "
            "a key")
    body = blob[len(_MAGIC):]
    if len(body) < _NONCE + _TAG:
        raise DecryptionError("truncated encrypted blob")
    nonce = body[:_NONCE]
    ct = body[_NONCE:-_TAG]
    tag = body[-_TAG:]
    mac_key = _derive(key, b"mac")
    want = hashlib.blake2b(nonce + ct, key=mac_key,
                           digest_size=_TAG).digest()
    if not hmac.compare_digest(tag, want):
        raise DecryptionError(
            "authentication failed: wrong key or tampered file")
    return _keystream_xor(ct, key, nonce)


class Cipher:
    """reference: framework/io/crypto/cipher.h Cipher interface —
    Encrypt/Decrypt over strings and files."""

    def encrypt(self, plaintext: bytes, key: bytes) -> bytes:
        return encrypt_bytes(plaintext, key)

    def decrypt(self, ciphertext: bytes, key: bytes) -> bytes:
        return decrypt_bytes(ciphertext, key)

    def encrypt_to_file(self, plaintext: bytes, key: bytes, path: str):
        with open(path, "wb") as f:
            f.write(self.encrypt(plaintext, key))

    def decrypt_from_file(self, key: bytes, path: str) -> bytes:
        with open(path, "rb") as f:
            return self.decrypt(f.read(), key)


class CipherFactory:
    """reference: cipher.h CipherFactory::CreateCipher; config files are
    unnecessary here — one authenticated scheme, keyed at call time."""

    @staticmethod
    def create_cipher(config_fname: str = "") -> Cipher:
        return Cipher()


def encrypt_file(src: str, dst: str, key: bytes):
    with open(src, "rb") as f:
        data = f.read()
    with open(dst, "wb") as f:
        f.write(encrypt_bytes(data, key))


def decrypt_file(src: str, dst: str, key: bytes):
    with open(src, "rb") as f:
        data = f.read()
    with open(dst, "wb") as f:
        f.write(decrypt_bytes(data, key))
