"""Database updater: applies FIG events, tracks per-entity completion stats.

Per-entity completion with stats {total, pending, completed, conflicts,
updates}. Counterpart of tpudab.database.updater, rewritten here because
the tpudab.database package imports jax.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, List, Optional

from tpudab_torch.database.entities import (
    Ensemble, Service, ServiceComponent, Subchannel, LinkService, FMService,
    DRMService, TransportMode,
)
from tpudab_torch.fic.fig_parser import FIGEvent


@dataclasses.dataclass
class DatabaseStatistics:
    total: int = 0
    pending: int = 0
    completed: int = 0
    conflicts: int = 0
    updates: int = 0


@dataclasses.dataclass
class MiscInfo:
    """Reference parity: dab/dab_misc_info.h (CIF counter + datetime),
    render_radio_block.cpp:28,813-840."""

    cif_counter: int = 0
    datetime_utc: Optional[datetime.datetime] = None


class Database:
    """Entity store. Keys: subchannels by subch_id, services by service_id,
    components by (service_id, index)."""

    def __init__(self):
        self.ensemble = Ensemble()
        self.services: Dict[int, Service] = {}
        self.service_components: Dict[tuple, ServiceComponent] = {}
        self.subchannels: Dict[int, Subchannel] = {}
        self.link_services: Dict[int, LinkService] = {}
        self.fm_services: Dict[int, FMService] = {}
        self.drm_services: Dict[int, DRMService] = {}

    def components_of(self, service_id: int) -> List[ServiceComponent]:
        return [c for (sid, _), c in sorted(self.service_components.items())
                if sid == service_id]

    def component_for_subchannel(self, subch_id: int) -> Optional[ServiceComponent]:
        for c in self.service_components.values():
            if c.subch_id == subch_id:
                return c
        return None


class DatabaseUpdater:
    """Applies FIGEvents to a Database, tracking stats and conflicts."""

    def __init__(self):
        self.db = Database()
        self.misc = MiscInfo()
        self.stats = DatabaseStatistics()
        self._completed = set()
        self.unhandled_counts: Dict[tuple, int] = {}

    # ------------- helpers -------------

    def _touch(self, kind: str, ident) -> None:
        db = self.db
        self.stats.total = (len(db.services) + len(db.subchannels)
                            + len(db.service_components) + 1)
        completed = int(bool(db.ensemble.label))
        completed += sum(1 for s in db.services.values() if s.label)
        completed += sum(1 for s in db.subchannels.values()
                         if s.size_cu > 0 or s.is_uep)
        completed += sum(1 for c in db.service_components.values()
                         if c.subch_id is not None)
        self.stats.completed = completed
        self.stats.pending = self.stats.total - completed

    # ------------- event application -------------

    def process_events(self, events) -> None:
        for ev in events:
            self.process_event(ev)

    def process_event(self, ev: FIGEvent) -> None:
        handler = getattr(self, f"_on_{ev.kind}", None)
        if handler is None or ev.kind == "unhandled":
            self.unhandled_counts[ev.kind] = self.unhandled_counts.get(ev.kind, 0) + 1
            return
        handler(ev.data)
        self.stats.updates += 1
        self._touch(ev.kind, None)

    def _service(self, sid: int) -> Service:
        if sid not in self.db.services:
            self.db.services[sid] = Service(service_id=sid)
        return self.db.services[sid]

    def _subchannel(self, subch_id: int) -> Subchannel:
        if subch_id not in self.db.subchannels:
            self.db.subchannels[subch_id] = Subchannel(subch_id=subch_id)
        return self.db.subchannels[subch_id]

    def _on_ensemble(self, d):
        e = self.db.ensemble
        e.ensemble_id = d["ensemble_id"]
        e.alarm = bool(d.get("alarm", 0))
        self.misc.cif_counter = d.get("cif_counter", self.misc.cif_counter)
        e.cif_counter = self.misc.cif_counter

    def _on_subchannel(self, d):
        s = self._subchannel(d["subch_id"])
        s.start_cu = d["start_cu"]
        if d.get("is_uep"):
            s.is_uep = True
            s.uep_index = d["uep_index"]
        else:
            s.is_uep = False
            s.size_cu = d["size_cu"]
            s.eep_level = d["eep_level"]
            s.eep_option = d["eep_option"]

    def _on_service_component(self, d):
        sid = d["service_id"]
        svc = self._service(sid)
        tm = TransportMode(d["tmid"])
        # identify component by subchannel (stream) or SCId (packet)
        if tm == TransportMode.PACKET_DATA:
            key = (sid, ("scid", d["scid"]))
        else:
            key = (sid, ("subch", d["subch_id"]))
        comp = self.db.service_components.get(key)
        if comp is None:
            comp = ServiceComponent(service_id=sid, component_id=len(svc.components))
            self.db.service_components[key] = comp
            svc.components.append(key)
        comp.transport_mode = tm
        comp.is_primary = bool(d.get("ps", 1))
        if tm == TransportMode.STREAM_AUDIO:
            comp.audio_type = d["ty"]
            comp.subch_id = d["subch_id"]
        elif tm in (TransportMode.STREAM_DATA, TransportMode.FIDC):
            comp.data_type = d["ty"]
            comp.subch_id = d["subch_id"]
        else:
            comp.scid = d["scid"]

    def _on_packet_component(self, d):
        # FIG 0/3 links SCId -> subchannel + packet address + DSCTy
        for comp in self.db.service_components.values():
            if comp.scid == d["scid"]:
                comp.subch_id = d["subch_id"]
                comp.data_type = d["dscty"]
                comp.packet_address = d["packet_address"]
                comp.dg_flag = d["dg_flag"]

    def _on_component_language(self, d):
        lang = d["language"]
        for comp in self.db.service_components.values():
            if ("subch_id" in d and comp.subch_id == d["subch_id"]) or \
               ("scid" in d and comp.scid == d.get("scid")):
                comp.language = lang

    def _on_component_global(self, d):
        sid = d["service_id"]
        for (s, key), comp in self.db.service_components.items():
            if s != sid:
                continue
            if "subch_id" in d and comp.subch_id == d["subch_id"]:
                comp.component_id = d["scids"]
            elif "scid" in d and comp.scid == d["scid"]:
                comp.component_id = d["scids"]

    def _on_country_lto(self, d):
        e = self.db.ensemble
        e.ecc = d["ecc"]
        e.lto_half_hours = d["lto_half_hours"]
        e.inter_table_id = d["inter_table_id"]
        for svc in self.db.services.values():
            if svc.ecc == 0:
                svc.ecc = d["ecc"]

    def _on_datetime(self, d):
        mjd = d["mjd"]
        # MJD -> civil date
        jd = mjd + 2_400_000.5
        a = int(jd + 0.5)
        f = jd + 0.5 - a
        if a < 2_299_161:
            c = a
        else:
            alpha = int((a - 1_867_216.25) / 36_524.25)
            c = a + 1 + alpha - alpha // 4
        dd = c + 1524
        e = int((dd - 122.1) / 365.25)
        fdy = int(365.25 * e)
        g = int((dd - fdy) / 30.6001)
        day = dd - fdy - int(30.6001 * g)
        month = g - 1 if g < 13.5 else g - 13
        year = e - 4716 if month > 2.5 else e - 4715
        try:
            self.misc.datetime_utc = datetime.datetime(
                year, month, day, d["hours"], d["minutes"], d.get("seconds", 0),
                d.get("milliseconds", 0) * 1000, tzinfo=datetime.timezone.utc)
        except ValueError:
            pass

    def _on_programme_type(self, d):
        svc = self._service(d["service_id"])
        svc.programme_type = d["programme_type"]
        if "language" in d:
            svc.language = d["language"]

    def _on_user_application(self, d):
        # record MOT/slideshow user apps on the component
        sid = d["service_id"]
        for (s, _), comp in self.db.service_components.items():
            if s == sid:
                comp_ua = getattr(comp, "user_applications", None)
                if comp_ua is None:
                    comp.user_applications = []  # type: ignore[attr-defined]
                comp.user_applications.append(  # type: ignore[attr-defined]
                    {"ua_type": d["ua_type"], "scids": d["scids"]})

    def _on_subchannel_fec(self, d):
        self._subchannel(d["subch_id"]).fec_scheme = d["fec_scheme"]

    def _on_service_linkage(self, d):
        lsn = d["link_session"]
        if lsn not in self.db.link_services:
            self.db.link_services[lsn] = LinkService(link_session=lsn)
        link = self.db.link_services[lsn]
        link.active = bool(d.get("active", 0))
        link.hard = bool(d.get("hard", 0))
        link.international = bool(d.get("international", 0))
        idlq = d.get("id_list_qualifier")
        for ident in d.get("ids", []):
            if idlq == 1:  # RDS PI codes -> FM services
                if ident not in self.db.fm_services:
                    self.db.fm_services[ident] = FMService(rds_pi=ident, link_session=lsn)
            elif idlq == 2:  # DRM ids
                if ident not in self.db.drm_services:
                    self.db.drm_services[ident] = DRMService(drm_id=ident, link_session=lsn)
            elif idlq == 0:
                link.service_id = ident

    def _on_frequency_info(self, d):
        rm = d.get("rm")
        if rm == 8:  # FM with RDS
            pi = d["id"]
            if pi not in self.db.fm_services:
                self.db.fm_services[pi] = FMService(rds_pi=pi)
            self.db.fm_services[pi].frequencies = d.get("frequencies", [])
        elif rm == 6:
            drm_id = d["id"]  # 16-bit id field keys the entity (matches 0/6)
            if drm_id not in self.db.drm_services:
                self.db.drm_services[drm_id] = DRMService(drm_id=drm_id)
            self.db.drm_services[drm_id].frequencies = d.get("frequencies", [])

    def _on_ensemble_label(self, d):
        self.db.ensemble.label = d["label"]

    def _on_service_label(self, d):
        self._service(d["service_id"]).label = d["label"]

    def _on_component_label(self, d):
        sid = d["service_id"]
        for (s, _), comp in self.db.service_components.items():
            if s == sid and comp.component_id == d.get("scids", comp.component_id):
                comp.label = d["label"]

    def _on_unhandled(self, d):
        pass

    def _on_parse_error(self, d):
        self.stats.conflicts += 1
