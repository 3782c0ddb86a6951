"""Host-side native code of the port (C++ built at first use with g++)."""
