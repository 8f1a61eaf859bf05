"""Host-side native code of the port: the C++ PNG decode/resize loader."""
