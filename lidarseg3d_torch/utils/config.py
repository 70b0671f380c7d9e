"""Python-module experiment configs with dot access (own copy of
lidarseg3d_tpu/utils/config.py): the config file is a plain Python module,
every non-dunder top-level name becomes a key, nested dicts get attribute
access."""

import copy
import importlib.util
import os
import shutil
import sys
import tempfile


class ConfigDict(dict):
    """dict with attribute access, recursively applied."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, dict) and not isinstance(v, ConfigDict):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, self._wrap(v))

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self):
        def unwrap(v):
            if isinstance(v, ConfigDict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(unwrap(x) for x in v)
            return v

        return unwrap(self)


def _drop_config_modules():
    """Forget every imported module of the repository's ``configs``
    package."""
    for name in [n for n in sys.modules
                 if n == "configs" or n.startswith("configs.")]:
        del sys.modules[name]


class Config:
    def __init__(self, cfg_dict=None, filename=None, text=""):
        self._cfg_dict = ConfigDict(cfg_dict or {})
        self._filename = filename
        self._text = text

    @staticmethod
    def fromfile(filename):
        filename = os.path.abspath(os.path.expanduser(filename))
        if not os.path.isfile(filename):
            raise FileNotFoundError(filename)
        if not filename.endswith(".py"):
            raise ValueError("Only .py config files are supported")
        # import the config as a throwaway module (copied to a temp dir so
        # the config directory itself is importable for sibling configs).
        # A config that star-imports a base config (the lidar baselines)
        # edits the base module's dicts in place, so the base is imported
        # afresh for every load and dropped after it: a cached base would
        # carry one config's edits into the next load of another
        _drop_config_modules()
        with tempfile.TemporaryDirectory() as tmpdir:
            tmp_path = os.path.join(tmpdir, "_tmp_cfg_module.py")
            shutil.copyfile(filename, tmp_path)
            sys.path.insert(0, os.path.dirname(filename))
            try:
                spec = importlib.util.spec_from_file_location(
                    "_tmp_cfg_module", tmp_path)
                mod = importlib.util.module_from_spec(spec)
                mod.__file__ = filename
                spec.loader.exec_module(mod)
            finally:
                sys.path.pop(0)
                sys.modules.pop("_tmp_cfg_module", None)
                _drop_config_modules()
            cfg_dict = {k: v for k, v in mod.__dict__.items()
                        if not k.startswith("__")}
        with open(filename) as f:
            text = f.read()
        return Config(cfg_dict, filename=filename, text=text)

    @property
    def filename(self):
        return self._filename

    @property
    def text(self):
        return self._text

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._cfg_dict, name)

    def __getitem__(self, name):
        return self._cfg_dict[name]

    def __setattr__(self, name, value):
        if name.startswith("_"):
            super().__setattr__(name, value)
        else:
            self._cfg_dict[name] = value

    def __contains__(self, name):
        return name in self._cfg_dict

    def get(self, key, default=None):
        return self._cfg_dict.get(key, default)

    def keys(self):
        return self._cfg_dict.keys()

    def to_dict(self):
        return self._cfg_dict.to_dict()
