"""The orchestration facade: one typed entry point assembling
producers -> extractors (pose / face / hand) -> savers / GUI.

Mirrors the reference's single most load-bearing API artifact, the
OpenPose ``Wrapper`` (configure(WrapperStruct...) / exec / start / stop
and the async emplaceAndPop surface,
``openpose/include/openpose/wrapper/wrapper.hpp:73-227``; the worker
graph assembly ``wrapperAuxiliary.hpp:970-1158``; construction-time
``wrapperConfigureSanityChecks``). This redesign collapses the
thread/queue worker graph into jitted per-frame extractor calls plus a
plain Python pump thread — XLA owns the intra-step parallelism, the
host loop only feeds frames and drains results.

Typical use (examples/03, 04, 10, 11 and ``cli.py pose`` are built on
this):

    from perception.wrapper import Perception, WrapperStructInput
    p = Perception(input=WrapperStructInput(source="frames_dir/"))
    for datum in p.exec():
        print(datum.frame_index, int(datum.people.mask.sum()))

or the async form::

    p.start()
    ...
    datum = p.wait_and_pop()
    p.stop()
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np


# --------------------------------------------------------------------
# Typed configuration structs (WrapperStructPose/Face/Hand/Input/
# Output/Gui, flags.hpp -> wrapperStructPose.hpp layering).
# --------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WrapperStructPose:
    enabled: bool = True
    topology: str = "MPI_15"
    net_hw: Tuple[int, int] = (128, 128)
    scales: Tuple[float, ...] = (1.0,)
    params: Any = None          # None -> trained fixture if present,
                                # else randomly initialized net
    top_n: int = 0              # KeepTopNPeople (0 = keep all)


@dataclasses.dataclass(frozen=True)
class WrapperStructFace:
    enabled: bool = False
    params: Any = None          # None -> trained face fixture
    max_faces: int = 4          # tracker slots (model replication,
                                # openface2_ros.cpp:174-183)
    detect_every: int = 1       # detector cadence in frames
                                # (round(30/rate), openface2_ros.cpp:236)


@dataclasses.dataclass(frozen=True)
class WrapperStructHand:
    enabled: bool = False
    params: Any = None          # None -> trained hand fixture
    top_n_people: int = 1       # run left+right hands for the first N
                                # people (handDetector.cpp runs both
                                # wrists of every person)


@dataclasses.dataclass(frozen=True)
class WrapperStructInput:
    source: Any = None          # reader with .frames(), directory str,
                                # video path, or sequence of arrays
    frame_limit: Optional[int] = None
    fps_keep: Optional[float] = None  # producer pacing (producer.cpp
                                      # fps-keeping; io/producers.paced)


@dataclasses.dataclass(frozen=True)
class WrapperStructOutput:
    json_dir: Optional[str] = None     # per-frame people JSON
    video_path: Optional[str] = None   # rendered frames (requires gui
                                       # overlay or raw frames)
    udp: Optional[Tuple[str, int]] = None  # keypoint datagrams


@dataclasses.dataclass(frozen=True)
class WrapperStructGui:
    display: bool = False       # FrameDisplayer window (falls back to
                                # the headless sink off-display)
    info_overlay: bool = True   # FPS/people counter overlay


class PerceptionDatum(NamedTuple):
    """The pipeline's unit of work (core/datum.hpp:41-160 analog)."""
    frame_index: int
    timestamp: float
    image: np.ndarray
    people: Any                 # ops.paf.People (keypoints/score/mask)
    faces: Any                  # dict of face outputs or None
    hands: Any                  # dict of hand outputs or None


class Perception:
    """Facade: configure once, then ``exec()`` / ``start()``+``pop`` /
    ``emplace_and_pop()``."""

    def __init__(
        self,
        pose: WrapperStructPose = WrapperStructPose(),
        face: WrapperStructFace = WrapperStructFace(),
        hand: WrapperStructHand = WrapperStructHand(),
        input: Optional[WrapperStructInput] = None,
        output: Optional[WrapperStructOutput] = None,
        gui: Optional[WrapperStructGui] = None,
    ):
        self.pose_cfg = pose
        self.face_cfg = face
        self.hand_cfg = hand
        self.input_cfg = input or WrapperStructInput()
        self.output_cfg = output or WrapperStructOutput()
        self.gui_cfg = gui or WrapperStructGui()
        self._sanity_checks()
        self._build()
        self._thread: Optional[threading.Thread] = None
        self._out_q: "queue.Queue[Optional[PerceptionDatum]]" = queue.Queue(maxsize=8)
        self._stop = threading.Event()

    # -- sanity checks (wrapperConfigureSanityChecks) -----------------
    def _sanity_checks(self) -> None:
        p, f, h = self.pose_cfg, self.face_cfg, self.hand_cfg
        if not (p.enabled or f.enabled or h.enabled):
            raise ValueError("no extractor enabled: set pose/face/hand")
        if h.enabled and not p.enabled:
            raise ValueError(
                "hand extraction needs pose keypoints for the hand ROI "
                "(reference: HandDetector from wrist/elbow keypoints)"
            )
        if p.enabled:
            if p.net_hw[0] % 8 or p.net_hw[1] % 8:
                raise ValueError(f"pose net_hw must be multiples of 8, got {p.net_hw}")
            if not p.scales or any(s <= 0 for s in p.scales):
                raise ValueError(f"bad scale pyramid {p.scales}")
            if p.top_n < 0:
                raise ValueError("top_n must be >= 0")
        if f.enabled and f.max_faces < 1:
            raise ValueError("max_faces must be >= 1")
        if f.enabled and f.detect_every < 1:
            raise ValueError("detect_every must be >= 1")
        if h.enabled and h.top_n_people < 1:
            raise ValueError("top_n_people must be >= 1")
        o = self.output_cfg
        if o.video_path is not None and not str(o.video_path).endswith(
            (".mp4", ".avi", ".mkv")
        ):
            raise ValueError(f"unsupported video container: {o.video_path}")
        i = self.input_cfg
        if i.fps_keep is not None and i.fps_keep <= 0:
            raise ValueError("fps_keep must be positive")
        if i.frame_limit is not None and i.frame_limit < 1:
            raise ValueError("frame_limit must be >= 1")

    # -- graph assembly ----------------------------------------------
    def _build(self) -> None:
        import jax
        import jax.numpy as jnp

        self._pose_fn = None
        self._face_fn = None
        self._hand_fn = None

        if self.pose_cfg.enabled:
            from perception.models import pose_fixture as PF
            from perception.models.pose import extract_people, init_posenet
            from perception.utils.keypoints import keep_top_n_people

            cfg = self.pose_cfg
            params = cfg.params
            net = None
            topology = cfg.topology
            net_hw = cfg.net_hw
            if params is None and PF.fixture_available() and (
                topology == PF.FIXTURE_TOPOLOGY
            ):
                params = PF.load_fixture()
                net = PF.tiny_posenet()
                net_hw = PF.FIXTURE_HW
            elif params is None:
                params = init_posenet(jax.random.key(0), topology, net_hw)
            self._pose_params = params

            def pose_fn(p, image):
                ppl = extract_people(
                    p, image, topology, scales=cfg.scales, net_hw=net_hw,
                    net=net,
                )
                if cfg.top_n:
                    kp, sc, m = keep_top_n_people(
                        ppl.keypoints, ppl.score, ppl.mask, n=cfg.top_n
                    )
                    ppl = ppl._replace(keypoints=kp, score=sc, mask=m)
                return ppl

            self._pose_fn = jax.jit(pose_fn)

        if self.face_cfg.enabled:
            from perception.models import face_fixture as FF
            from perception.models import face_multi as FM

            fparams = self.face_cfg.params
            if fparams is None:
                if not FF.fixture_available():
                    raise ValueError(
                        "face enabled but no params given and the trained "
                        "face fixture is absent (tools/train_face_fixture.py)"
                    )
                fparams = FF.load_fixture()
            self._face_params = fparams
            self._face_state = FM.init_tracks(self.face_cfg.max_faces)
            self._frame_count = 0

            def face_fn(p, gray, state, detect):
                # Native-resolution multi-face chain (models/face_multi):
                # detect (throttled) -> tracker slots -> batched
                # crop/landmark/PnP/gaze/AU — one jitted dispatch for
                # up to max_faces faces. Focal length scales with image
                # size relative to the fixture's training resolution.
                H, W = gray.shape
                s = max(H, W) / max(FF.FIXTURE_HW)
                fx = FF.FIXTURE_FX * s
                return FM.multi_face_step(
                    p, gray, state, fx, fx, W / 2.0, H / 2.0, detect,
                    crop=FF.FIXTURE_CROP,
                )

            self._face_fn = face_fn

        if self.hand_cfg.enabled:
            from perception.models import hand_fixture as HF
            from perception.models.hand import (
                LEFT_ARM,
                RIGHT_ARM,
                hand_roi_from_pose,
            )

            hparams = self.hand_cfg.params
            if hparams is None:
                if not HF.fixture_available():
                    raise ValueError(
                        "hand enabled but no params given and the trained "
                        "hand fixture is absent (tools/train_hand_fixture.py)"
                    )
                hparams = HF.load_fixture()
            self._hand_params = hparams
            n_people = self.hand_cfg.top_n_people

            def hand_fn(p, gray, keypoints, people_mask):
                # Left+right hand ROIs for the first N people, one
                # batched extraction (handDetector.cpp runs both wrists
                # per person; models/hand.py arm chains).
                kp = keypoints[:n_people]
                pm = people_mask[:n_people]

                def rois(kp1):
                    bl, okl = hand_roi_from_pose(kp1, arm=LEFT_ARM)
                    br, okr = hand_roi_from_pose(kp1, arm=RIGHT_ARM)
                    return jnp.stack([bl, br]), jnp.stack([okl, okr])

                boxes, ok = jax.vmap(rois)(kp)        # (N, 2, 4), (N, 2)
                flat = boxes.reshape(-1, 4)
                uv, m, _sc = jax.vmap(
                    lambda b: HF.extract_hand_tiny(p, gray, b)
                )(flat)
                valid = ok & pm[:, None]
                return {
                    "boxes": boxes,                    # (N, 2, 4) [L, R]
                    "box_valid": valid,                # (N, 2)
                    "landmarks": uv.reshape(n_people, 2, -1, 2),
                    "landmark_mask": (
                        m.reshape(n_people, 2, -1) & valid[..., None]
                    ),
                }

            self._hand_fn = hand_fn

        # ONE jitted dispatch per frame assembling every enabled
        # extractor (the reference's whole worker-graph forward,
        # wrapperAuxiliary.hpp:970-1158, as a single XLA program).
        pose_fn, face_fn, hand_fn = self._pose_fn, self._face_fn, self._hand_fn

        def step(params, img, face_state, detect):
            # Input-scale normalization happens IN-GRAPH (a host-side
            # img.max() would force a blocking device-to-host sync per
            # frame): img_unit in [0, 1] for the pose net,
            # gray8 in [0, 255] for the face/hand extractors, whatever
            # scale the caller fed.
            img_unit = jnp.where(jnp.max(img) > 1.5, img / 255.0, img)
            gray8 = jnp.mean(img_unit, axis=-1) * 255.0
            people = faces = hands = None
            if pose_fn is not None:
                people = pose_fn(params["pose"], img_unit)
            if face_fn is not None:
                face_state, faces = face_fn(
                    params["face"], gray8, face_state, detect
                )
            if hand_fn is not None and people is not None:
                hands = hand_fn(
                    params["hand"], gray8, people.keypoints, people.mask
                )
            return people, faces, hands, face_state

        self._step_fn = jax.jit(step)
        self._params = {
            "pose": getattr(self, "_pose_params", None),
            "face": getattr(self, "_face_params", None),
            "hand": getattr(self, "_hand_params", None),
        }

        # Output sinks.
        self._savers = []
        o = self.output_cfg
        if o.udp is not None:
            from perception.io.savers import UdpSender

            self._udp = UdpSender(*o.udp)
        else:
            self._udp = None
        if o.video_path is not None:
            from perception.io.savers import VideoWriter

            self._video = VideoWriter(o.video_path)
        else:
            self._video = None
        if self.gui_cfg.display:
            from perception.io.gui import Gui

            self._gui = Gui()
        else:
            self._gui = None

    # -- synchronous single-frame API (emplaceAndPop) -----------------
    def emplace_and_pop(self, image, frame_index: int = 0,
                        timestamp: Optional[float] = None) -> PerceptionDatum:
        """Run every enabled extractor on one frame (one jitted
        dispatch)."""
        import jax.numpy as jnp

        img = jnp.asarray(image, jnp.float32)
        if img.ndim == 2:
            img = img[..., None] * jnp.ones((1, 1, 3), jnp.float32)

        detect = True
        if self._face_fn is not None:
            every = self.face_cfg.detect_every
            detect = (self._frame_count % every) == 0
            self._frame_count += 1
        people, faces, hands, new_state = self._step_fn(
            self._params, img,
            getattr(self, "_face_state", None), jnp.bool_(detect),
        )
        if self._face_fn is not None:
            self._face_state = new_state
        datum = PerceptionDatum(
            frame_index=frame_index,
            timestamp=time.time() if timestamp is None else timestamp,
            # Host frames stay host; device-staged frames stay on
            # device (an unconditional np.asarray would be a blocking
            # D2H per frame for callers that pre-stage, e.g. the
            # facade bench) — sinks convert when they consume.
            image=image if hasattr(image, "devices") else np.asarray(image),
            people=people,
            faces=faces,
            hands=hands,
        )
        self._route_outputs(datum)
        return datum

    def _route_outputs(self, datum: PerceptionDatum) -> None:
        o = self.output_cfg
        if o.json_dir is not None and datum.people is not None:
            from pathlib import Path

            from perception.io.savers import save_people_json

            Path(o.json_dir).mkdir(parents=True, exist_ok=True)
            save_people_json(
                Path(o.json_dir) / f"people_{datum.frame_index:06d}.json",
                np.asarray(datum.people.keypoints),
                np.asarray(datum.people.mask),
            )
        if self._udp is not None and datum.people is not None:
            self._udp.send_array(np.asarray(datum.people.keypoints))
        if self._video is not None:
            frame = datum.image
            if frame.ndim == 2:
                frame = np.stack([frame] * 3, -1)
            self._video.write(frame.astype(np.uint8))
        if self._gui is not None:
            n = (int(np.asarray(datum.people.mask).sum())
                 if datum.people is not None else None)
            self._gui.update(datum.image.astype(np.uint8), num_people=n)

    # -- producer plumbing --------------------------------------------
    def _frames(self) -> Iterator[Tuple[float, np.ndarray]]:
        from perception.io import producers as prod

        src = self.input_cfg.source
        if src is None:
            raise ValueError("exec()/start() need WrapperStructInput.source")
        if hasattr(src, "frames"):
            it = src.frames()
        elif isinstance(src, (list, tuple)) or (
            isinstance(src, np.ndarray) and src.ndim == 4
        ):
            it = ((float(i), np.asarray(f)) for i, f in enumerate(src))
        else:
            s = str(src)
            if s.endswith((".mp4", ".avi", ".mkv", ".mov")):
                it = prod.VideoReader(s).frames()
            else:
                it = prod.ImageDirectoryReader(s).frames()
        if self.input_cfg.fps_keep is not None:
            it = prod.paced(it, self.input_cfg.fps_keep)
        return it

    # -- synchronous run (Wrapper::exec) ------------------------------
    def exec(self) -> Iterator[PerceptionDatum]:
        limit = self.input_cfg.frame_limit
        for i, (t, frame) in enumerate(self._frames()):
            if limit is not None and i >= limit:
                break
            yield self.emplace_and_pop(frame, frame_index=i, timestamp=t)

    # -- async run (Wrapper::start/stop + waitAndPop) -----------------
    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("already started")
        self._stop.clear()

        def put_observing_stop(item) -> bool:
            """Bounded put that re-checks _stop so a consumer that quits
            without draining can't wedge the pump thread forever."""
            while not self._stop.is_set():
                try:
                    self._out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def pump():
            try:
                for datum in self.exec():
                    if self._stop.is_set():
                        break
                    if not put_observing_stop(datum):
                        break
            finally:
                put_observing_stop(None)  # end-of-stream sentinel

        self._thread = threading.Thread(target=pump, daemon=True)
        self._thread.start()

    def try_pop(self) -> Optional[PerceptionDatum]:
        try:
            return self._out_q.get_nowait()
        except queue.Empty:
            return None

    def wait_and_pop(self, timeout: Optional[float] = None) -> Optional[PerceptionDatum]:
        """Next datum, or None at end-of-stream."""
        return self._out_q.get(timeout=timeout)

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            # Drain the queue while joining so a pump blocked on a full
            # queue exits promptly; only close sinks once the thread has
            # actually stopped (no write-after-close races).
            deadline = time.monotonic() + 10.0
            while thread.is_alive() and time.monotonic() < deadline:
                try:
                    self._out_q.get_nowait()
                except queue.Empty:
                    pass
                thread.join(timeout=0.1)
            self._thread = None
        if thread is None or not thread.is_alive():
            if self._video is not None:
                self._video.close()
            if self._udp is not None:
                self._udp.close()
            if self._gui is not None:
                self._gui.close()
