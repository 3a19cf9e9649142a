from .runner import fetch_hostfile, parse_resource_filter, main  # noqa: F401
