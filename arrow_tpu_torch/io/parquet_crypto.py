"""Parquet Modular Encryption — AES_GCM_V1 (encrypted-footer mode).

Re-designs the reference's encryption subsystem for this engine's
host-side codec:

  module AAD construction     parquet/src/encryption/modules.rs:38
  GCM block cipher framing    parquet/src/encryption/ciphers.rs:26-65
                              ([u32 len][12B nonce][ciphertext][16B tag])
  encrypt/decrypt properties  parquet/src/encryption/encrypt.rs,
                              decrypt.rs (FileEncryption/Decryption
                              Properties, key retriever)

AES-GCM itself comes from the `cryptography` package (the reference
uses ring); everything else — AADs, module framing, key metadata — is
hand-rolled here.  `pkmt1_key_material` emits the Parquet key-management
JSON envelope (single-wrap, internal storage) so files interoperate
with pyarrow's CryptoFactory KMS layer, proven by tests.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

__all__ = ["FileEncryptionProperties", "FileDecryptionProperties",
           "module_aad", "encrypt_module", "decrypt_module",
           "M_FOOTER", "M_COLMD", "M_DATAPAGE", "M_DICTPAGE",
           "M_DATAPAGE_HDR", "M_DICTPAGE_HDR", "M_COLIDX", "M_OFFIDX",
           "pkmt1_key_material", "pkmt1_unwrap"]

(M_FOOTER, M_COLMD, M_DATAPAGE, M_DICTPAGE, M_DATAPAGE_HDR,
 M_DICTPAGE_HDR, M_COLIDX, M_OFFIDX, M_BLOOM_HDR, M_BLOOM_BITSET) = \
    range(10)

NONCE_LEN = 12
TAG_LEN = 16


def _aesgcm(key: bytes):
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    return AESGCM(key)


def module_aad(file_aad: bytes, mtype: int, rg: int = 0, col: int = 0,
               page: Optional[int] = None) -> bytes:
    """modules.rs:38 — footer AADs carry no ordinals, data-page modules
    carry (rg, col, page) as i16 LE, everything else (rg, col)."""
    if mtype == M_FOOTER:
        return file_aad + bytes([mtype])
    for name, v in (("row group", rg), ("column", col)):
        if v > 32767:
            raise ArrowInvalid(
                f"encrypted parquet: {name} ordinal {v} exceeds the "
                f"spec's i16 AAD limit (32767)")
    aad = file_aad + bytes([mtype]) + struct.pack("<hh", rg, col)
    if mtype in (M_DATAPAGE, M_DATAPAGE_HDR):
        if page is None:
            raise ValueError("page ordinal required for data pages")
        if page > 32767:
            raise ArrowInvalid(
                f"encrypted parquet: page ordinal {page} exceeds the "
                f"spec's i16 AAD limit (32767); lower data_page_size "
                f"or split row groups")
        aad += struct.pack("<h", page)
    return aad


def encrypt_module(key: bytes, plaintext: bytes, aad: bytes) -> bytes:
    nonce = os.urandom(NONCE_LEN)
    ct = _aesgcm(key).encrypt(nonce, plaintext, aad)
    return struct.pack("<I", NONCE_LEN + len(ct)) + nonce + ct


def decrypt_module(key: bytes, buf, aad: bytes, pos: int = 0):
    """-> (plaintext, end_pos)."""
    (ln,) = struct.unpack_from("<I", buf, pos)
    nonce = bytes(buf[pos + 4:pos + 4 + NONCE_LEN])
    ct = bytes(buf[pos + 4 + NONCE_LEN:pos + 4 + ln])
    return _aesgcm(key).decrypt(nonce, ct, aad), pos + 4 + ln


@dataclass
class FileEncryptionProperties:
    """encrypt.rs FileEncryptionProperties role.

    column_keys empty -> uniform encryption (every column under the
    footer key).  Non-empty -> the listed columns are encrypted with
    their own keys, unlisted columns stay PLAINTEXT (the spec's and
    pyarrow's column-key behavior)."""
    footer_key: bytes
    column_keys: Dict[str, bytes] = field(default_factory=dict)
    aad_prefix: bytes = b""
    store_aad_prefix: bool = True
    footer_key_metadata: bytes = b""
    column_key_metadata: Dict[str, bytes] = field(default_factory=dict)

    def key_for(self, path: str):
        """(key, crypto_mode) for a leaf path: 'footer' | 'column' |
        None (plaintext)."""
        if path in self.column_keys:
            return self.column_keys[path], "column"
        if not self.column_keys:
            return self.footer_key, "footer"
        return None, None


@dataclass
class FileDecryptionProperties:
    """decrypt.rs FileDecryptionProperties role.  key_retriever maps a
    key_metadata blob to the key (the DecryptionKeyRetriever trait)."""
    footer_key: Optional[bytes] = None
    column_keys: Dict[str, bytes] = field(default_factory=dict)
    key_retriever: Optional[Callable[[bytes], bytes]] = None
    aad_prefix: bytes = b""

    def resolve_footer(self, key_metadata: bytes) -> bytes:
        if self.footer_key is not None:
            return self.footer_key
        if self.key_retriever is not None and key_metadata:
            return self.key_retriever(key_metadata)
        raise ValueError("no footer key available for encrypted footer")

    def resolve_column(self, path: str, key_metadata: bytes) -> bytes:
        if path in self.column_keys:
            return self.column_keys[path]
        if self.key_retriever is not None and key_metadata:
            return self.key_retriever(key_metadata)
        if self.footer_key is not None and not key_metadata:
            return self.footer_key
        raise ValueError(f"no key for encrypted column {path!r}")


# ---------------------------------------------------------------------------
# pyarrow KMS interop: the parquet-mr key-tools JSON envelope (PKMT1)
# ---------------------------------------------------------------------------

def pkmt1_key_material(wrapped_dek_b64: str, master_key_id: str,
                       is_footer: bool,
                       kms_instance_id: str = "DEFAULT",
                       kms_instance_url: str = "DEFAULT") -> bytes:
    """Single-wrap internal-storage key material understood by
    pyarrow's CryptoFactory (double_wrapping=False)."""
    d = {"keyMaterialType": "PKMT1", "internalStorage": True,
         "isFooterKey": bool(is_footer)}
    if is_footer:
        d["kmsInstanceID"] = kms_instance_id
        d["kmsInstanceURL"] = kms_instance_url
    d["masterKeyID"] = master_key_id
    d["doubleWrapping"] = False
    d["wrappedDEK"] = wrapped_dek_b64
    return json.dumps(d).encode()


def pkmt1_unwrap(key_metadata: bytes,
                 unwrap: Callable[[str, str], bytes]) -> bytes:
    """Parse a PKMT1 envelope and unwrap via `unwrap(wrapped_b64,
    master_key_id)` (the KmsClient.unwrap_key signature)."""
    d = json.loads(key_metadata.decode())
    if d.get("keyMaterialType") != "PKMT1":
        raise ValueError("not PKMT1 key material")
    if d.get("doubleWrapping"):
        raise ValueError("double-wrapped key material not supported")
    return unwrap(d["wrappedDEK"], d["masterKeyID"])
