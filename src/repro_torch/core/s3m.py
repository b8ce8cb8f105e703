"""S3M (Secure Scientific Service Mesh) managed-provisioning model
(paper §3.1, §4.5 — the facility service behind the MSS architecture).

S3M fronts MSS: users present project-scoped, time-limited tokens; the
Streaming API validates them against project allocations and policy
rules, provisions the requested streaming service onto DSNs, and
returns an FQDN-based AMQPS URL — web-style access on port 443, the
property that makes MSS the most deployable of the three architectures
(outbound 443 is all a user needs).  :meth:`S3MService.provision_cluster`
mirrors the paper's REST call::

    POST /olcf/v1alpha/streaming/rabbitmq/provision_cluster
    {"kind": "general", "name": "rabbitmq",
     "resourceSettings": {"cpus": 12, "ram-gbs": 32, "nodes": 3,
                          "max-msg-size": 536870912}}

:class:`ResourceSettings` enforces the allocation-policy bounds, and the
returned :class:`ManagedCluster` carries the user-facing FQDN
(``rabbitmq-<project>-<n>.apps.olivine.ccs.ornl.gov``) plus the DSN
placement; :meth:`S3MService.submit_compute` is the Compute API hook.

A copy of the reference package's ``s3m`` module, with its names,
defaults and error messages.  The cluster counter is this module's own.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Callable, Optional

S3M_BASE_URL = "https://s3m.apps.olivine.ccs.ornl.gov/olcf/v1alpha"

_cluster_counter = itertools.count(1)


class S3MError(RuntimeError):
    pass


class S3MAuthError(S3MError):
    pass


@dataclasses.dataclass(frozen=True)
class Token:
    project: str
    permissions: frozenset[str]
    issued_at: float
    ttl_s: float
    secret: str

    def expired(self, now: float) -> bool:
        return now > self.issued_at + self.ttl_s


@dataclasses.dataclass
class ResourceSettings:
    cpus: int = 12
    ram_gbs: int = 32
    nodes: int = 3
    max_msg_size: int = 536_870_912

    def validate(self) -> None:
        if self.nodes < 1 or self.nodes > 8:
            raise S3MError(f"nodes={self.nodes} outside allocation policy [1,8]")
        if self.cpus < 1 or self.cpus > 48:
            raise S3MError(f"cpus={self.cpus} outside allocation policy [1,48]")
        if self.ram_gbs < 1 or self.ram_gbs > 256:
            raise S3MError(f"ram-gbs={self.ram_gbs} outside allocation policy")


@dataclasses.dataclass
class ManagedCluster:
    """What provision_cluster returns: an FQDN users hand to their AMQP
    client plus the provisioned resource footprint."""

    name: str
    kind: str
    project: str
    settings: ResourceSettings
    fqdn: str
    amqps_url: str
    dsn_placement: list[int]


class S3MService:
    """The facility side: Istio-style policy checks + provisioning."""

    def __init__(self, n_dsn: int = 3,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.n_dsn = n_dsn
        self._clock = clock or (lambda: 0.0)
        self._tokens: dict[str, Token] = {}
        self._allocations: dict[str, dict] = {}     # project -> quota
        self.clusters: dict[str, ManagedCluster] = {}

    # -- auth ----------------------------------------------------------------
    def register_project(self, project: str, max_clusters: int = 2) -> None:
        self._allocations[project] = {
            "max_clusters": max_clusters, "clusters": 0}

    def issue_token(self, project: str,
                    permissions: tuple[str, ...] = ("streaming:provision",),
                    ttl_s: float = 3600.0) -> Token:
        if project not in self._allocations:
            raise S3MAuthError(f"project {project!r} has no allocation")
        secret = hashlib.sha256(
            f"{project}:{self._clock()}:{len(self._tokens)}".encode()
        ).hexdigest()
        tok = Token(project=project, permissions=frozenset(permissions),
                    issued_at=self._clock(), ttl_s=ttl_s, secret=secret)
        self._tokens[secret] = tok
        return tok

    def _authorize(self, token: Token, permission: str) -> None:
        known = self._tokens.get(token.secret)
        if known is None or known != token:
            raise S3MAuthError("unknown or forged token")
        if token.expired(self._clock()):
            raise S3MAuthError("token expired")
        if permission not in token.permissions:
            raise S3MAuthError(f"token lacks permission {permission!r}")

    # -- Streaming API ----------------------------------------------------------
    def provision_cluster(self, token: Token, *, kind: str = "general",
                          name: str = "rabbitmq",
                          settings: Optional[ResourceSettings] = None
                          ) -> ManagedCluster:
        self._authorize(token, "streaming:provision")
        settings = settings or ResourceSettings()
        settings.validate()
        alloc = self._allocations[token.project]
        if alloc["clusters"] >= alloc["max_clusters"]:
            raise S3MError(
                f"project {token.project} at cluster quota "
                f"({alloc['max_clusters']})")
        if settings.nodes > self.n_dsn:
            raise S3MError(
                f"requested {settings.nodes} nodes but only {self.n_dsn} DSNs")
        cid = next(_cluster_counter)
        fqdn = f"{name}-{token.project}-{cid}.apps.olivine.ccs.ornl.gov"
        cluster = ManagedCluster(
            name=name, kind=kind, project=token.project, settings=settings,
            fqdn=fqdn, amqps_url=f"amqps://{fqdn}:443",
            dsn_placement=list(range(settings.nodes)))
        alloc["clusters"] += 1
        self.clusters[fqdn] = cluster
        return cluster

    def deprovision(self, token: Token, fqdn: str) -> None:
        self._authorize(token, "streaming:provision")
        c = self.clusters.pop(fqdn, None)
        if c is not None:
            self._allocations[c.project]["clusters"] -= 1

    # -- Compute API (dynamic compute orchestration, §3.1) -------------------------
    def submit_compute(self, token: Token, *, system: str,
                       job_spec: dict) -> dict:
        self._authorize(token, "compute:submit")
        return {
            "system": system,
            "job_id": f"{system}-{hashlib.sha1(repr(sorted(job_spec.items())).encode()).hexdigest()[:8]}",
            "state": "QUEUED",
            "spec": dict(job_spec),
        }
