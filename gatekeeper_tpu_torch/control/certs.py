"""Webhook certificate rotation.

Counterpart of the reference pkg/webhook/certs.go: self-signed CA +
server certificate (10-year validity, 90-day renewal lookahead, 12-hour
check interval, certs.go:35-41,332), persisted in the
gatekeeper-webhook-server-cert Secret, with the CA bundle injected into
the ValidatingWebhookConfiguration (certs.go:170) and re-injected when the
VWH or Secret changes (ReconcileVWH, certs.go:454).
"""

from __future__ import annotations

import base64
import datetime
import os
import threading
from typing import Optional

try:
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID
except ImportError:  # gated: rotation raises, the rest of the control
    x509 = hashes = serialization = rsa = NameOID = None  # plane runs

from .kube import KubeError, NotFound
from .logging import logger


def _require_crypto() -> None:
    if x509 is None:
        raise RuntimeError(
            "cert rotation requires the 'cryptography' package; install "
            "it or run with --disable-cert-rotation")

log = logger("cert-rotation")

CA_VALIDITY = datetime.timedelta(days=10 * 365)
LOOKAHEAD = datetime.timedelta(days=90)
CHECK_INTERVAL = 12 * 3600  # seconds
SECRET_NAME = "gatekeeper-webhook-server-cert"
VWH_NAME = "gatekeeper-validating-webhook-configuration"
MWH_NAME = "gatekeeper-mutating-webhook-configuration"
SECRET_GVK = ("", "v1", "Secret")
VWH_GVK = ("admissionregistration.k8s.io", "v1beta1",
           "ValidatingWebhookConfiguration")
MWH_GVK = ("admissionregistration.k8s.io", "v1beta1",
           "MutatingWebhookConfiguration")


def _new_key():
    _require_crypto()
    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


def _pem_key(key) -> bytes:
    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption())


def _pem_cert(cert) -> bytes:
    return cert.public_bytes(serialization.Encoding.PEM)


def generate_ca(common_name: str = "gatekeeper-ca"):
    key = _new_key()
    now = datetime.datetime.now(datetime.timezone.utc)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + CA_VALIDITY)
            .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                           critical=True)
            .add_extension(x509.KeyUsage(
                digital_signature=True, key_cert_sign=True, crl_sign=True,
                content_commitment=False, key_encipherment=False,
                data_encipherment=False, key_agreement=False,
                encipher_only=False, decipher_only=False), critical=True)
            .sign(key, hashes.SHA256()))
    return key, cert


def generate_server_cert(ca_key, ca_cert, dns_names: list[str]):
    key = _new_key()
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(x509.Name([
                x509.NameAttribute(NameOID.COMMON_NAME, dns_names[0])]))
            .issuer_name(ca_cert.subject)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + CA_VALIDITY)
            .add_extension(x509.SubjectAlternativeName(
                [x509.DNSName(n) for n in dns_names]), critical=False)
            .add_extension(x509.ExtendedKeyUsage(
                [x509.ExtendedKeyUsageOID.SERVER_AUTH]), critical=False)
            .sign(ca_key, hashes.SHA256()))
    return key, cert


def _needs_refresh(cert_pem: bytes) -> bool:
    _require_crypto()
    try:
        cert = x509.load_pem_x509_certificate(cert_pem)
    except ValueError:
        return True
    now = datetime.datetime.now(datetime.timezone.utc)
    return cert.not_valid_after_utc - now < LOOKAHEAD


class CertRotator:
    def __init__(self, kube, cert_dir: str,
                 service_name: str = "gatekeeper-webhook-service",
                 namespace: str = "gatekeeper-system",
                 secret_name: str = SECRET_NAME,
                 vwh_name: str = VWH_NAME,
                 mwh_name: str = MWH_NAME):
        self.kube = kube
        self.cert_dir = cert_dir
        self.dns_names = [
            f"{service_name}.{namespace}.svc",
            f"{service_name}.{namespace}.svc.cluster.local",
        ]
        self.namespace = namespace
        self.secret_name = secret_name
        self.vwh_name = vwh_name
        self.mwh_name = mwh_name
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._reconcile_thread: Optional[threading.Thread] = None
        self._registrar = None
        self._ca_pem: Optional[bytes] = None
        # the 12h rotation loop and the watch-driven reconciler both
        # call refresh_certs; interleaved regeneration would mix cert
        # and key from different generations on disk
        self._refresh_lock = threading.Lock()

    # ------------------------------------------------------------ lifecycle

    def start(self, watch_manager=None) -> None:
        self.refresh_certs()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="cert-rotator")
        self._thread.start()
        if watch_manager is not None:
            self.start_reconciler(watch_manager)

    def stop(self) -> None:
        self._stop.set()
        if self._registrar is not None:
            from .kube import WatchEvent

            # unblock the reconcile drain, then drop the watches
            self._registrar.events.put(WatchEvent("_STOP", {}))
            for gvk in list(self._registrar.gvks):
                self._registrar.remove_watch(gvk)

    def _loop(self) -> None:
        while not self._stop.wait(CHECK_INTERVAL):
            try:
                self.refresh_certs()
            except Exception as e:
                log.error("cert refresh failed", details=str(e))

    # ----------------------------------------------------------- reconciler

    def start_reconciler(self, watch_manager) -> None:
        """ReconcileVWH analog (reference certs.go:454-530): watch the
        ValidatingWebhookConfiguration and the cert Secret and re-inject
        the CA bundle the moment either changes — a VWH recreated
        between 12-hour refresh ticks must not serve an unbundled config
        until the next tick."""
        reg = watch_manager.registrar("cert-reconciler")
        reg.add_watch(VWH_GVK)
        reg.add_watch(MWH_GVK)
        reg.add_watch(SECRET_GVK)
        self._registrar = reg
        self._reconcile_thread = threading.Thread(
            target=self._reconcile_loop, daemon=True,
            name="cert-reconciler")
        self._reconcile_thread.start()

    def _reconcile_loop(self) -> None:
        import queue

        reg = self._registrar
        while not self._stop.is_set():
            try:
                event = reg.events.get(timeout=1.0)
            except queue.Empty:
                continue
            try:
                self._reconcile_event(event)
            except Exception as e:
                log.error("cert reconcile failed", details=str(e))

    def _reconcile_event(self, event) -> None:
        obj = event.object or {}
        meta = obj.get("metadata") or {}
        kind = obj.get("kind")
        if kind in ("ValidatingWebhookConfiguration",
                    "MutatingWebhookConfiguration"):
            if meta.get("name") not in (self.vwh_name, self.mwh_name) or \
                    event.type == "DELETED":
                return
            if self._ca_pem:
                self.inject_ca(self._ca_pem)
        elif kind == "Secret":
            if meta.get("name") != self.secret_name or \
                    (meta.get("namespace") or "") != self.namespace:
                return
            # deleted or externally modified: regenerate/reload and
            # re-inject (refresh is idempotent when the secret is valid,
            # so our own writes do not loop)
            self.refresh_certs()

    # -------------------------------------------------------------- refresh

    def refresh_certs(self) -> None:
        with self._refresh_lock:
            self._refresh_certs_locked()

    def _refresh_certs_locked(self) -> None:
        secret = self._load_secret()
        data = (secret or {}).get("data") or {}
        ca_pem = base64.b64decode(data.get("ca.crt") or b"")
        cert_pem = base64.b64decode(data.get("tls.crt") or b"")
        if not ca_pem or not cert_pem or _needs_refresh(cert_pem) or \
                _needs_refresh(ca_pem):
            log.info("generating new webhook certificates")
            ca_key, ca_cert = generate_ca()
            key, cert = generate_server_cert(ca_key, ca_cert, self.dns_names)
            ca_pem = _pem_cert(ca_cert)
            cert_pem = _pem_cert(cert)
            key_pem = _pem_key(key)
            self._store_secret(ca_pem, _pem_key(ca_key), cert_pem, key_pem)
        else:
            key_pem = base64.b64decode(data.get("tls.key") or b"")
        self._write_files(cert_pem, key_pem, ca_pem)
        self._ca_pem = ca_pem
        self.inject_ca(ca_pem)

    def _load_secret(self) -> Optional[dict]:
        try:
            return self.kube.get(SECRET_GVK, self.secret_name,
                                 self.namespace)
        except (NotFound, KubeError):
            return None

    def _store_secret(self, ca_pem, ca_key_pem, cert_pem, key_pem) -> None:
        secret = {
            "apiVersion": "v1", "kind": "Secret",
            "metadata": {"name": self.secret_name,
                         "namespace": self.namespace},
            "type": "kubernetes.io/tls",
            "data": {
                "ca.crt": base64.b64encode(ca_pem).decode(),
                "ca.key": base64.b64encode(ca_key_pem).decode(),
                "tls.crt": base64.b64encode(cert_pem).decode(),
                "tls.key": base64.b64encode(key_pem).decode(),
            },
        }
        try:
            self.kube.apply(secret)
        except KubeError as e:
            log.warning("could not persist cert secret", details=str(e))

    def _write_files(self, cert_pem: bytes, key_pem: bytes,
                     ca_pem: bytes) -> None:
        os.makedirs(self.cert_dir, exist_ok=True)
        for fname, blob in (("tls.crt", cert_pem), ("tls.key", key_pem),
                            ("ca.crt", ca_pem)):
            path = os.path.join(self.cert_dir, fname)
            with open(path, "wb") as f:
                f.write(blob)
        os.chmod(os.path.join(self.cert_dir, "tls.key"), 0o600)

    def inject_ca(self, ca_pem: bytes) -> None:
        """caBundle injection into every webhook of the VWH and (when
        deployed) the MutatingWebhookConfiguration (certs.go:170-233)."""
        bundle = base64.b64encode(ca_pem).decode()
        for gvk, name in ((VWH_GVK, self.vwh_name),
                          (MWH_GVK, self.mwh_name)):
            try:
                cfg = self.kube.get(gvk, name)
            except (NotFound, KubeError):
                continue
            changed = False
            for wh in cfg.get("webhooks") or []:
                cc = wh.setdefault("clientConfig", {})
                if cc.get("caBundle") != bundle:
                    cc["caBundle"] = bundle
                    changed = True
            if changed:
                try:
                    self.kube.update(cfg)
                    log.info("injected CA bundle into webhook "
                             "configuration", details={"name": name})
                except KubeError as e:
                    log.warning("CA injection failed", details=str(e))
