from .interface import register_interface, call_interface, clear_interfaces
from .config import AttrDict, ConfigManager, CheckResult
from .pipeline import Module, ModuleManager, PipelineStatus
