from .server import PerceptionServer
from .upgrade import UpgradeManager, UpgradeServer
