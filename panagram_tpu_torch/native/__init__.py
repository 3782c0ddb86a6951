"""Host-side native code of the port (C++ built at first use with g++)."""

from . import bgzf_native  # noqa: F401
