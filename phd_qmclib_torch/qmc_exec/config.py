"""Config-file loading (YAML/TOML) and Jinja2 templating.

Copy of ``phd_qmclib_tpu.qmc_exec.config``, after the upstream
library's ``qmc_exec/config.py``.  YAML uses PyYAML, TOML the stdlib
``tomllib`` (the upstream library uses ruamel/toml - the same schemas
load unchanged).  ``yaml`` and ``jinja2`` are imported by the functions
that parse or render, so the module imports where they are missing.
"""
import os
import pathlib
import tomllib
import typing as t
from dataclasses import dataclass

__all__ = ["Loader", "Template"]

CONFIG_FILE_EXTENSIONS = (".yml", ".yaml", ".toml")
YAML_EXTENSIONS = (".yml", ".yaml")
UNIX_NEWLINE = "\n"


@dataclass(frozen=True)
class Loader:
    """Load the configuration for a QMC procedure
    (``qmc_exec/config.py:23-108``)."""

    #: Valid extensions for configuration files.
    file_extensions: t.Tuple[str, ...] = CONFIG_FILE_EXTENSIONS
    #: IO-handler type tags whose locations are file paths.
    io_file_handler_types: t.Tuple[str, ...] = ("HDF5_FILE",)

    def load(self, location: t.Union[str, pathlib.Path]) -> dict:
        path = pathlib.Path(location)
        suffix = path.suffix
        if not suffix:
            raise IOError("config file has no extension")
        if suffix not in self.file_extensions:
            raise IOError("unknown file extension")

        if suffix in YAML_EXTENSIONS:
            import yaml

            with path.open("r") as fp:
                config_data = yaml.safe_load(fp)
        else:
            with path.open("rb") as fp:
                config_data = tomllib.load(fp)

        # Keep support for old config files.
        if "main_proc_set" in config_data:
            config_data["app_spec"] = config_data.pop("main_proc_set")

        app_spec_data = config_data["app_spec"]
        if isinstance(app_spec_data, t.Sequence) \
                and not isinstance(app_spec_data, (str, bytes, t.Mapping)):
            app_spec_config_set = list(app_spec_data)
        else:
            app_spec_config_set = [app_spec_data]

        loc_parent = path.absolute().parent
        for app_spec_conf in app_spec_config_set:
            self.fix_app_spec_locations(app_spec_conf, loc_parent)

        config_data["app_spec"] = app_spec_config_set
        return config_data

    def fix_app_spec_locations(self, app_spec_config: t.MutableMapping,
                               config_path: pathlib.Path):
        """Resolve relative IO paths against the config file's directory
        (``qmc_exec/config.py:78-108``)."""
        if "input" in app_spec_config:
            app_spec_config["proc_input"] = app_spec_config.pop("input")
        if "output" in app_spec_config:
            app_spec_config["proc_output"] = app_spec_config.pop("output")

        for key in ("proc_input", "proc_output"):
            handler = app_spec_config.get(key)
            if handler is None:
                # wf_opt stanzas have no output handler (the optimized
                # spec flows into the following stanzas instead), and
                # their input handler is optional.
                continue
            if handler["type"] in self.io_file_handler_types:
                location = handler["location"]
                handler["location"] = str(config_path / location)
        # The mid-run checkpoint file (an extension of the upstream layout)
        # resolves the same way as the IO handlers — a relative
        # ``checkpoint_file`` previously landed in the process CWD
        # while the output went next to the config, splitting one
        # run's files across two directories.
        proc = app_spec_config.get("proc")
        if isinstance(proc, t.MutableMapping) \
                and proc.get("checkpoint_file"):
            ckpt = pathlib.Path(proc["checkpoint_file"])
            if not ckpt.is_absolute():
                proc["checkpoint_file"] = str(config_path / ckpt)


@dataclass(frozen=True)
class Template:
    """Jinja2 template of a procedure config
    (``qmc_exec/config.py:111-177``)."""

    path: pathlib.Path
    #: Variables injected into the render context (unit constants etc.).
    vars: t.Mapping = None

    @property
    def name(self):
        return self.path.name

    @property
    def dirname(self):
        return self.path.parent

    @property
    def environ(self) -> "jinja2.Environment":
        import jinja2

        loader = jinja2.FileSystemLoader([str(self.dirname), os.getcwd()],
                                         followlinks=True)
        return jinja2.Environment(loader=loader, trim_blocks=True,
                                  lstrip_blocks=True)

    def render(self, context: t.Mapping) -> str:
        template = self.environ.get_template(self.name)
        return template.render(context)

    def save(self, config_path: pathlib.Path):
        context = dict(self.vars or {})
        context.update({
            "template_name": self.path.stem,
            "config_filename": config_path.stem,
        })
        import yaml

        config = yaml.safe_load(self.render(context))
        with config_path.open("w", encoding="utf-8",
                              newline=UNIX_NEWLINE) as config_file:
            yaml.safe_dump(config, stream=config_file, sort_keys=False,
                           indent=4, allow_unicode=True)
