"""TLS certificate generation for gossip transport security.

The port's copy of `corrosion_tpu/tls.py`.

Counterpart of `klukai-types/src/tls.rs:17-100` (rcgen-based CA / server /
client certificate generation) and the `corrosion tls {ca,server,client}
generate` CLI commands (`klukai/src/command/tls.rs`). Uses the
`cryptography` package instead of rcgen.

The port imports `cryptography` inside the generation functions only:
`build_ssl_contexts` (stdlib `ssl`) and the module itself work on a host
that lacks the package; generating a certificate there raises
ImportError.
"""

from __future__ import annotations

import datetime
import ipaddress
from pathlib import Path
from typing import TYPE_CHECKING, Optional, Tuple

if TYPE_CHECKING:  # annotations only: the functions import at call time
    from cryptography import x509
    from cryptography.hazmat.primitives.asymmetric import ec

CA_COMMON_NAME = "Corrosion TPU Root CA"
_ONE_DAY = datetime.timedelta(days=1)
_TEN_YEARS = datetime.timedelta(days=3650)


def _write_pem(path: Path, data: bytes) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)


def _key_pems(key) -> bytes:
    from cryptography.hazmat.primitives import serialization

    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )


def _now() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc)


def generate_ca(
    cert_path: str, key_path: str
) -> Tuple[x509.Certificate, ec.EllipticCurvePrivateKey]:
    """Self-signed CA (tls.rs:17-40)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, CA_COMMON_NAME)]
    )
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(_now() - _ONE_DAY)
        .not_valid_after(_now() + _TEN_YEARS)
        .add_extension(x509.BasicConstraints(ca=True, path_length=None), True)
        .add_extension(
            x509.KeyUsage(
                digital_signature=True,
                key_cert_sign=True,
                crl_sign=True,
                content_commitment=False,
                key_encipherment=False,
                data_encipherment=False,
                key_agreement=False,
                encipher_only=False,
                decipher_only=False,
            ),
            True,
        )
        .sign(key, hashes.SHA256())
    )
    _write_pem(Path(cert_path), cert.public_bytes(serialization.Encoding.PEM))
    _write_pem(Path(key_path), _key_pems(key))
    return cert, key


def _load_ca(
    ca_cert_path: str, ca_key_path: str
) -> Tuple[x509.Certificate, ec.EllipticCurvePrivateKey]:
    from cryptography import x509
    from cryptography.hazmat.primitives import serialization

    cert = x509.load_pem_x509_certificate(Path(ca_cert_path).read_bytes())
    key = serialization.load_pem_private_key(
        Path(ca_key_path).read_bytes(), password=None
    )
    return cert, key


def _issue(
    ca_cert: x509.Certificate,
    ca_key,
    common_name: str,
    san: Optional[x509.SubjectAlternativeName],
    extended_usage: x509.ExtendedKeyUsage,
) -> Tuple[x509.Certificate, ec.EllipticCurvePrivateKey]:
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    builder = (
        x509.CertificateBuilder()
        .subject_name(
            x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
        )
        .issuer_name(ca_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(_now() - _ONE_DAY)
        .not_valid_after(_now() + _TEN_YEARS)
        .add_extension(x509.BasicConstraints(ca=False, path_length=None), True)
        .add_extension(extended_usage, False)
    )
    if san is not None:
        builder = builder.add_extension(san, False)
    cert = builder.sign(ca_key, hashes.SHA256())
    return cert, key


def generate_server_cert(
    ca_cert_path: str,
    ca_key_path: str,
    ip: str,
    cert_path: str = "./server-cert.pem",
    key_path: str = "./server-key.pem",
) -> None:
    """Server cert with the gossip IP as SAN (tls.rs:42-75)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import serialization

    ca_cert, ca_key = _load_ca(ca_cert_path, ca_key_path)
    try:
        san_entry: x509.GeneralName = x509.IPAddress(
            ipaddress.ip_address(ip)
        )
    except ValueError:
        san_entry = x509.DNSName(ip)
    cert, key = _issue(
        ca_cert,
        ca_key,
        common_name=ip,
        san=x509.SubjectAlternativeName([san_entry]),
        extended_usage=x509.ExtendedKeyUsage(
            [x509.oid.ExtendedKeyUsageOID.SERVER_AUTH]
        ),
    )
    _write_pem(Path(cert_path), cert.public_bytes(serialization.Encoding.PEM))
    _write_pem(Path(key_path), _key_pems(key))


def generate_client_cert(
    ca_cert_path: str,
    ca_key_path: str,
    cert_path: str = "./client-cert.pem",
    key_path: str = "./client-key.pem",
) -> None:
    """Client cert for mTLS gossip (tls.rs:77-100)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import serialization

    ca_cert, ca_key = _load_ca(ca_cert_path, ca_key_path)
    cert, key = _issue(
        ca_cert,
        ca_key,
        common_name="corrosion-tpu-client",
        san=None,
        extended_usage=x509.ExtendedKeyUsage(
            [x509.oid.ExtendedKeyUsageOID.CLIENT_AUTH]
        ),
    )
    _write_pem(Path(cert_path), cert.public_bytes(serialization.Encoding.PEM))
    _write_pem(Path(key_path), _key_pems(key))


def build_ssl_contexts(tls_cfg):
    """(server_ctx, client_ctx) for the gossip TCP lanes from a
    `runtime.config.GossipTlsConfig`.

    Mirrors the reference's rustls endpoint setup
    (`klukai-agent/src/api/peer/mod.rs:152-373`): the server presents
    cert_file/key_file and, with `mtls`, requires + verifies client
    certificates against ca_file; the client verifies the server against
    ca_file unless `insecure` (SkipServerVerification,
    `peer/mod.rs:386-442`), and presents client_cert_file when configured.
    """
    import ssl

    if not tls_cfg.cert_file or not tls_cfg.key_file:
        raise ValueError("gossip TLS requires cert_file and key_file")

    server = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server.load_cert_chain(tls_cfg.cert_file, tls_cfg.key_file)
    if tls_cfg.mtls:
        if not tls_cfg.ca_file:
            raise ValueError("mtls requires ca_file")
        server.verify_mode = ssl.CERT_REQUIRED
        server.load_verify_locations(tls_cfg.ca_file)

    client = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    if tls_cfg.insecure:
        client.check_hostname = False
        client.verify_mode = ssl.CERT_NONE
    else:
        if not tls_cfg.ca_file:
            raise ValueError("non-insecure TLS requires ca_file to verify peers")
        client.load_verify_locations(tls_cfg.ca_file)
    if tls_cfg.client_cert_file and tls_cfg.client_key_file:
        client.load_cert_chain(tls_cfg.client_cert_file, tls_cfg.client_key_file)
    return server, client
