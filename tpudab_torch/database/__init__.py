"""The service database fed by FIG events (counterpart of tpudab.database)."""

from tpudab_torch.database.entities import (
    Ensemble, Service, ServiceComponent, Subchannel, LinkService, FMService,
    DRMService, TransportMode, AudioServiceType, DataServiceType,
)
from tpudab_torch.database.updater import DatabaseUpdater, Database, DatabaseStatistics
