from .config import Config, default_config, dump_config, load_config

__all__ = ["Config", "default_config", "dump_config", "load_config"]
