"""Dedicated MaiMod app on the port (the repo's ``mai_mod_ui.py``).

Serves the MaiMod analysis page standalone (the combined UI also serves it
at ``/mai-mod``): beatmap + model selection, teacher-forced surprisal
analysis in a worker process (:func:`.mai_mod.run_analysis`), SSE log
streaming, and a categorized suggestion table with ``osu://edit`` links.

    python -m mapperatorinator_tpu_torch.mai_mod_ui [--port 8766] [--device cpu] [--window]

The worker runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import sys

from .web_ui import REPO_ROOT, Handler, make_server, parse_cli, serve  # shared job/SSE machinery


class MaiModHandler(Handler):
    """Same routes as the combined UI, but '/' is the MaiMod page."""

    def do_GET(self):
        if self.path == "/" or self.path.startswith("/?"):
            self._file(REPO_ROOT / "template" / "index_mai_mod.html", "text/html; charset=utf-8")
            return
        super().do_GET()


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    port, device, window = parse_cli(argv, 8766)
    url = f"http://127.0.0.1:{port}"
    if window:
        try:
            import webview

            serve(port, device=device, handler=MaiModHandler)
            webview.create_window("MaiMod", url)
            webview.start()
            return
        except ImportError:
            print("pywebview not available; serving in browser mode")
    server = make_server(port, device=device, handler=MaiModHandler)
    print(f"MaiMod UI at {url}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
